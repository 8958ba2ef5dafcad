"""xgan_torch's serving artifacts of the CGAN generator and the
classifier, full precision and int8, against the live port model and the
JAX package's own artifact (``tests/torch_port_util.py`` states the
tolerances); ``xgan_torch.cli.export_model`` against ``src/export_model.py``:
the same envelope JSON for the same flags, the same refusals."""
import importlib.util
import io
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch

from tests.torch_port_util import (EXPORT_FG, EXPORT_LATENT, EXPORT_SIZE,
                                   build_artifacts, check_against_jax,
                                   check_int8_small, check_round_trip,
                                   check_sampler_reads_pt2, export_models)
from xgan.io_ import checkpoint as jax_ckpt
from xgan_torch.cli import export_model
from xgan_torch.io_ import export

torch.set_num_threads(1)

KINDS = ("cgan", "classifier")
CASES = [(k, q) for k in KINDS for q in ("none", "int8")]
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


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
    check_int8_small(built, "classifier")


def test_sampler_reads_a_pt2(built, tmp_path, capsys):
    check_sampler_reads_pt2(built, "cgan", tmp_path, capsys)


def _header(path):
    with open(path, "rb") as f:
        return export.split_envelope(f.read())[0]


def _jax_export_main(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_export_model", os.path.join(SRC, "export_model.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["export_model.py", *argv]
    try:
        with redirect_stdout(io.StringIO()):
            mod.main()
    finally:
        sys.argv = old


@pytest.mark.parametrize("kind,q,dt", [("gan", "none", "auto"),
                                       ("wgan", "int8", "bf16"),
                                       ("cgan", "int8", "f32")])
def test_envelope_matches_the_jax_cli(tmp_path, kind, q, dt):
    """The JSON header the JAX CLI writes for these flags is the one the
    port's CLI writes (``artifact_meta``)."""
    _, v, _ = export_models(kind)
    ckpt = str(tmp_path / "g.msgpack")
    jax_ckpt.save_variables(ckpt, v)
    flags = ["--cpu", "--kind", kind, "--model-path", ckpt, "--image-size",
             str(EXPORT_SIZE), "--latent-dim", str(EXPORT_LATENT),
             "--feature-maps-g", str(EXPORT_FG), "--quantize", q,
             "--compute-dtype", dt, "--skip-verify"]
    _jax_export_main(flags + ["--output", str(tmp_path / "a.stablehlo")])
    args = export_model.build_parser().parse_args(flags + ["--output", "x"])
    dtype = {"auto": torch.float32, "bf16": torch.bfloat16,
             "f32": torch.float32}[dt]
    assert export_model.artifact_meta(args, dtype) == \
        _header(tmp_path / "a.stablehlo")


def test_export_cli_classifier(tmp_path, capsys):
    """The CLI on a JAX classifier checkpoint: int8, verified, the JAX
    CLI's classifier keys (src/export_model.py:127-136); refusals."""
    _, v, _ = export_models("classifier")
    ckpt = str(tmp_path / "baseline_resnet50.msgpack")
    jax_ckpt.save_variables(ckpt, v)
    out = str(tmp_path / "clf.pt2")
    stats = export_model.main([
        "--cpu", "--kind", "classifier", "--model-path", ckpt, "--output",
        out, "--image-size", str(EXPORT_SIZE), "--quantize", "int8",
        "--resnet-stages", "1,1,1,1"])
    text = capsys.readouterr().out
    assert stats["verified"] and "Verified: artifact output matches" in text
    assert _header(out) == {"kind": "classifier", "image_size": EXPORT_SIZE,
                            "compute_dtype": "float32", "quantize": "int8",
                            "num_classes": 2}
    for argv, msg in (
            (["--output", str(tmp_path / "x.stablehlo"), "--model-path",
              ckpt], "writes .pt2 artifacts"),
            (["--output", out, "--model-path", str(tmp_path / "no.msgpack")],
             "Error: model checkpoint not found"),
            (["--output", out, "--model-path", ckpt, "--resnet-stages",
              "1,1,1,2"], "Error loading classifier checkpoint")):
        with pytest.raises(SystemExit) as e:
            export_model.main(["--cpu", "--kind", "classifier", *argv])
        assert e.value.code == 1 and msg in capsys.readouterr().out


def test_export_cli_without_a_card_refuses(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks CUDA-less hosts")
    with pytest.raises(SystemExit) as e:
        export_model.main(["--kind", "gan", "--model-path", "g.pth",
                           "--output", str(tmp_path / "g.pt2")])
    assert e.value.code == 1
    assert capsys.readouterr().out.startswith("Error: ")
