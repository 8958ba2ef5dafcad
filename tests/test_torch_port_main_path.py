"""The main path end to end through the port's CLIs on the fixture
dataset, on the CPU at tiny widths: ``train_gan`` -> ``generate_synthetic``
from its ``generator_final.pth`` -> ``train_classifier`` with the
baseline, augmented and curriculum strategies (2-fold CV) on those images
-> ``analyze_results`` on the three runs. Checks that each stage reads
what the one before wrote and that the analyzer writes every output of
the JAX CLI: the report with all three runs, the comparison plots, the
SSIM distribution and a Grad-CAM panel per sample. Beside it, the CGAN
trainer and its sampler. A long chain, so it is marked slow."""
import os

import numpy as np
import pytest
import torch

from xgan_torch.cli import analyze_results, generate_synthetic
from xgan_torch.cli import generate_synthetic_cgan, train_cgan
from xgan_torch.cli import train_classifier, train_gan
from xgan_torch.native.png import decode_png

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

SIZE = 32
GAN_FLAGS = ["--image-size", str(SIZE), "--feature-maps-g", "8",
             "--latent-dim", "16"]


def test_main_path_through_the_port_clis(fake_dataset, tmp_path, capsys):
    data = fake_dataset["data_dir"]
    models, metrics = tmp_path / "models", tmp_path / "metrics"
    figures, synth = tmp_path / "figures", tmp_path / "synthetic"
    common = ["--cpu", "--data-dir", data, "--model-dir", str(models),
              "--results-dir", str(metrics), "--figures-dir", str(figures),
              "--cache-dir", str(tmp_path / "cache")]

    history = train_gan.main(common + GAN_FLAGS + [
        "--output-dir", str(tmp_path / "results"), "--feature-maps-d", "8",
        "--epochs", "1", "--batch-size", "16", "--vis-batch-size", "8"])
    assert np.isfinite(history["G_losses_iter"]).all()
    stats = generate_synthetic.main([
        "--cpu", "--model-path", str(models / "gan" / "generator_final.pth"),
        "--output-dir", str(synth), "--num-images", "10",
        "--batch-size", "5", *GAN_FLAGS])
    assert stats["written"] == 10

    for extra in ([], ["--use-synthetic"],
                  ["--use-synthetic", "--use-curriculum",
                   "--curriculum-schedule", "0:0.25,1:0.5"]):
        summary = train_classifier.main(common + [
            "--synthetic-dir", str(synth), "--image-size", str(SIZE),
            "--batch-size", "8", "--epochs", "2", "--k-folds", "2",
            "--resnet-stages", "1,1,1,1", *extra])
        assert set(summary) == {"folds", "average", "std_dev"}
    # the analyzer reads {prefix}resnet50.pth: a CV run writes per fold
    for run in ("baseline", "augmented", "curriculum"):
        os.replace(models / f"fold_1_{run}_resnet50.pth",
                   models / f"{run}_resnet50.pth")

    out = tmp_path / "analysis"
    capsys.readouterr()
    analyze_results.main([
        "--cpu", "--metrics-dir", str(metrics), "--analysis-dir", str(out),
        "--model-dir", str(models), "--data-dir", data,
        "--synthetic-dir", str(synth), "--image-size", str(SIZE),
        "--num-gradcam-samples", "1", "--resnet-stages", "1,1,1,1"])
    assert capsys.readouterr().out.count("Loaded model:") == 3
    names = sorted(os.listdir(out))
    panels = [n for n in names if n.startswith("gradcam_")]
    assert sorted(set(names) - set(panels)) == [
        "comparison_acc.png", "comparison_loss.png", "comparison_report.txt",
        "comparison_synthetic_ratio.png", "cv_comparison.png",
        "ssim_distribution.png"]
    assert sorted(n.split("_")[1] for n in panels) == [
        "real", "real", "synthetic"]
    report = (out / "comparison_report.txt").read_text()
    for run in ("Baseline", "Augmented", "Curriculum"):
        assert f"* {run}:" in report
    assert "percentage points vs Baseline Avg" in report
    for name in names:
        if name.endswith(".png"):
            assert decode_png(str(out / name)).std() > 0
    assert "gan_loss_curve.png" in os.listdir(figures)


def test_cgan_stage_through_the_port_clis(fake_dataset, tmp_path):
    """The CGAN trainer then its sampler on the trained generator: the
    conditional path beside the main one."""
    models, synth = tmp_path / "models", tmp_path / "cgan_synthetic"
    history = train_cgan.main([
        "--cpu", "--data-dir", fake_dataset["data_dir"],
        "--model-dir", str(models), "--output-dir", str(tmp_path / "results"),
        "--results-dir", str(tmp_path / "metrics"),
        "--figures-dir", str(tmp_path / "figures"),
        "--cache-dir", str(tmp_path / "cache"), *GAN_FLAGS,
        "--feature-maps-d", "8", "--epochs", "1", "--batch-size", "16",
        "--vis-batch-size", "8"])
    assert np.isfinite(history["perceptual_losses"]).all()
    stats = generate_synthetic_cgan.main([
        "--cpu", "--model-path", str(models / "cgan" / "generator_final.pth"),
        "--output-dir", str(synth), "--num-images", "6", "--batch-size", "4",
        *GAN_FLAGS])
    assert stats["written"] == 6
    assert decode_png(str(synth / "synthetic_00006.png")).shape == \
        (SIZE, SIZE, 3)
    assert os.listdir(tmp_path / "figures") == ["cgan_loss_curve.png"]
