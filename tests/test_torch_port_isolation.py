"""xgan_torch and chip_smoke.py import nothing of JAX or of the JAX
package, nor the host libraries the GPU host lacks (pandas, sklearn, PIL,
matplotlib, msgpack, ml_dtypes): the port must run on a host that has
only torch, numpy and scipy. Tests may import all of them."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "xgan"}
HOST_ONLY = {"pandas", "sklearn", "PIL", "matplotlib", "msgpack",
             "ml_dtypes"}
FILES = sorted((ROOT / "xgan_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_port_dist_worker.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "xgan_torch/kernels/convt.py" in names
    assert "xgan_torch/kernels/gather.py" in names
    assert "xgan_torch/cli/train_classifier.py" in names
    assert "xgan_torch/cli/train_gan.py" in names
    assert "xgan_torch/models/wgan.py" in names
    assert "xgan_torch/train/wgan.py" in names
    assert "xgan_torch/train/wgan_loop.py" in names
    assert "xgan_torch/cli/train_wggan.py" in names
    assert "xgan_torch/cli/generate_synthetic_wgan.py" in names
    assert "xgan_torch/models/vgg.py" in names
    assert "xgan_torch/models/cgan.py" in names
    assert "xgan_torch/train/cgan.py" in names
    assert "xgan_torch/train/cgan_loop.py" in names
    assert "xgan_torch/cli/train_cgan.py" in names
    assert "xgan_torch/cli/generate_synthetic_cgan.py" in names
    assert "xgan_torch/train/snapshot.py" in names
    assert "xgan_torch/train/ema.py" in names
    assert "xgan_torch/train/multistep.py" in names
    assert "xgan_torch/train/parallel_folds.py" in names
    assert "xgan_torch/train/parallel_cv.py" in names
    assert "xgan_torch/io_/msgpack.py" in names
    assert "xgan_torch/io_/checkpoint.py" in names
    assert "xgan_torch/io_/quant.py" in names
    assert "xgan_torch/io_/export.py" in names
    assert "xgan_torch/cli/export_model.py" in names
    assert "xgan_torch/cli/predict.py" in names
    assert "xgan_torch/cli/serve.py" in names
    assert "xgan_torch/cli/data_loader.py" in names
    assert "xgan_torch/parallel/mesh.py" in names
    assert "tests/torch_port_dist_worker.py" in names
    assert len(names) > 10


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_or_xgan_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_host_libraries_the_gpu_host_lacks(path):
    bad = sorted(set(_imported_roots(path)) & HOST_ONLY)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_sees_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom xgan.utils import StepTimer\n"
                 "def f():\n    import jax.numpy as jnp\n"
                 "from xgan_torch import config\n"
                 "def g():\n    from sklearn.metrics import roc_auc_score\n")
    assert set(_imported_roots(p)) & FORBIDDEN == {"xgan", "jax"}
    assert set(_imported_roots(p)) & HOST_ONLY == {"sklearn"}
