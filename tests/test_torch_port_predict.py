"""xgan_torch's predict CLI against src/predict.py on the fixture.

One full-depth ResNet-50 (src/predict.py builds that) as the JAX
package's ``.msgpack``, its torchvision ``.pth`` twin and the port's
``.pt2``: the port's three predictions.json files must be identical (the
artifact's f32 program is the model's); against src/predict.py on the
same ``.pth`` the keys are equal, and the labels wherever |p - 0.5| >
1e-2, the probabilities within 1e-2: the port's resize lands within one
u8 level of the JAX package's native one (a recorded deviation), which
moves a probability of this random net by up to a few 1e-3."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from xgan.io_.checkpoint import save_variables
from xgan.models.pretrained import save_torch_resnet50
from xgan.models.resnet import ResNet50 as JaxResNet50
from xgan_torch.cli import predict
from xgan_torch.io_ import export
from xgan_torch.io_.checkpoint import load_classifier_variables
from xgan_torch.models.resnet import ResNet50

torch.set_num_threads(1)

SIZE = 32
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same ResNet-50 as .msgpack, .pth and .pt2."""
    d = tmp_path_factory.mktemp("models")
    v = JaxResNet50(num_classes=2).init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    paths = {"msgpack": str(d / "baseline_resnet50.msgpack"),
             "pth": str(d / "baseline_resnet50.pth"),
             "pt2": str(d / "baseline.pt2")}
    save_variables(paths["msgpack"], {"params": v["params"],
                                      "batch_stats": v["batch_stats"]})
    save_torch_resnet50(paths["pth"], v["params"], v["batch_stats"])
    model = ResNet50(2)
    load_classifier_variables(paths["msgpack"], model)
    ep = export.export_program(
        export.build_program("classifier", model.eval()),
        export.example_inputs("classifier", image_size=SIZE, latent_dim=0,
                              device="cpu"))
    export.save_exported(paths["pt2"], ep, {"kind": "classifier"})
    return paths


def _port(path, input_dir, out, *extra):
    return predict.main(["--cpu", "--model-path", path, "--input-dir",
                         input_dir, "--output", out, "--image-size",
                         str(SIZE), "--batch-size", "4", *extra])


def test_three_formats_and_jax_predict_agree(checkpoints, fake_dataset,
                                             tmp_path, capsys):
    test_dir = os.path.join(fake_dataset["data_dir"], "Test")
    outs = {}
    for fmt, path in checkpoints.items():
        out = str(tmp_path / f"{fmt}.json")
        stats = _port(path, test_dir, out, *(["--image-size", "224"]
                                             if fmt == "pt2" else []))
        assert stats["num_images"] == fake_dataset["n_test"]
        with open(out) as f:
            outs[fmt] = json.load(f)
    assert "artifact takes 32px input" in capsys.readouterr().out
    for fmt in ("pth", "pt2"):
        assert outs[fmt]["predictions"] == outs["msgpack"]["predictions"]
        assert outs[fmt]["positive"] == outs["msgpack"]["positive"]

    ref = str(tmp_path / "jax.json")
    r = subprocess.run(
        [sys.executable, os.path.join(SRC, "predict.py"), "--cpu",
         "--model-path", checkpoints["pth"], "--input-dir", test_dir,
         "--output", ref, "--image-size", str(SIZE), "--batch-size", "4"],
        capture_output=True, text=True, timeout=500)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(ref) as f:
        want = json.load(f)
    got = outs["pth"]
    assert got.keys() == want.keys()
    assert got["num_images"] == want["num_images"] == fake_dataset["n_test"]
    for a, b in zip(got["predictions"], want["predictions"]):
        assert a.keys() == b.keys() and a["file"] == b["file"]
        assert abs(a["prob_positive"] - b["prob_positive"]) <= 1e-2
        if abs(b["prob_positive"] - 0.5) > 1e-2:
            assert a["label"] == b["label"]


def test_pads_the_last_batch(checkpoints, fake_dataset, tmp_path):
    """Batch 3 over 10 images (a padded tail) gives batch 4's results."""
    test_dir = os.path.join(fake_dataset["data_dir"], "Test")
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    _port(checkpoints["pth"], test_dir, a)
    _port(checkpoints["pth"], test_dir, b, "--batch-size", "3")
    with open(a) as fa, open(b) as fb:
        pa, pb = json.load(fa)["predictions"], json.load(fb)["predictions"]
    assert [p["label"] for p in pa] == [p["label"] for p in pb]
    for x, y in zip(pa, pb):
        assert abs(x["prob_positive"] - y["prob_positive"]) <= 1e-5


def test_structured_errors_match_jax(checkpoints, fake_dataset, tmp_path,
                                     capsys):
    """src/predict.py's messages and exit 1 for a missing checkpoint, a
    missing input dir, an empty one, a generator artifact and a
    checkpoint that is not a classifier."""
    from xgan_torch.models.dcgan import Generator
    test_dir = os.path.join(fake_dataset["data_dir"], "Test")
    empty = tmp_path / "empty"
    empty.mkdir()
    gen = str(tmp_path / "gen.pt2")
    ep = export.export_program(
        export.build_program("gan", Generator(8, 3, 4, 32).eval()),
        export.example_inputs("gan", image_size=32, latent_dim=8,
                              device="cpu"))
    export.save_exported(gen, ep)
    junk = tmp_path / "junk.msgpack"
    junk.write_bytes(b"\x80")
    cases = [
        (str(tmp_path / "whatever.msgpack"), test_dir,
         "Error: model checkpoint not found"),
        (checkpoints["pth"], str(tmp_path / "nope"),
         f"Error: input dir {tmp_path / 'nope'} not found"),
        (checkpoints["pth"], str(empty), f"No PNGs found in {empty}"),
        (gen, test_dir, "not a classifier artifact"),
        (str(junk), test_dir, "Error loading classifier checkpoint"),
    ]
    for model, input_dir, msg in cases:
        with pytest.raises(SystemExit) as e:
            _port(model, input_dir, str(tmp_path / "p.json"))
        assert e.value.code == 1
        assert msg in capsys.readouterr().out, msg


def test_without_a_card_refuses(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks CUDA-less hosts")
    with pytest.raises(SystemExit) as e:
        predict.main(["--model-path", "m.pth", "--input-dir", str(tmp_path)])
    assert e.value.code == 1
    assert capsys.readouterr().out.startswith("Error: ")
