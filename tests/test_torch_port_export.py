"""xgan_torch's serving artifacts (``.pt2``) of the generators that run
the ConvT kernel (DCGAN, WGAN-GP), full precision and int8, against the
live port model and the JAX package's own artifact of the same weights
(``tests/torch_port_util.py`` states the tolerances); the CGAN and the
classifier are in ``test_torch_port_export_cli.py``."""
import pytest
import torch

from tests.torch_port_util import (build_artifacts, check_against_jax,
                                   check_int8_small, check_round_trip,
                                   check_sampler_reads_pt2)
from xgan_torch.io_ import export

torch.set_num_threads(1)

KINDS = ("gan", "wgan")
CASES = [(k, q) for k in KINDS for q in ("none", "int8")]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return build_artifacts(tmp_path_factory.mktemp("artifacts"), KINDS)


@pytest.mark.parametrize("kind,q", CASES)
def test_round_trip_matches_the_live_model(built, kind, q):
    check_round_trip(built, kind, q)


@pytest.mark.parametrize("kind,q", CASES)
def test_matches_the_jax_artifact(built, kind, q):
    check_against_jax(built, kind, q)


def test_int8_artifact_keeps_int8_and_is_small(built):
    check_int8_small(built, "gan")


def test_refuses_an_artifact_of_another_device(built):
    """An artifact runs only on the kind of device it was exported on: a
    CPU artifact (the plain ConvT inside) is refused elsewhere."""
    _, path, _, _ = built[("gan", "none")]
    with pytest.raises(ValueError, match="exported on cpu"):
        export.load_exported_with_meta(path, torch.device("meta"))


def test_sampler_reads_a_pt2(built, tmp_path, capsys):
    check_sampler_reads_pt2(built, "gan", tmp_path, capsys)


@pytest.mark.parametrize("kind", KINDS)
def test_full_precision_program_holds_packed_tensors(built, kind):
    """A full-precision DCGAN or WGAN-GP artifact holds the packed eval
    tensors and the first BN, not the raw ConvT weights beside them; an
    int8 one the int8 weights, repacked on every call."""
    names = {n for n, _, _ in built[(kind, "none")][0].keys}
    assert {"w0_mat", "wp0", "scale0", "shift4"} <= names
    assert not [n for n in names if n.endswith(".weight")
                and not n.startswith("main.1.")]
    q8 = built[(kind, "int8")][0].keys
    assert sorted(n for n, _, q in q8 if q) == [
        f"main.{s}.weight" for s in (0, 12, 15, 3, 6, 9)]
