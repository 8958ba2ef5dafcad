"""Analyze and compare the baseline, augmented and curriculum runs on the
GPU (flags and defaults as src/analyze_results.py).

    python -m xgan_torch.cli.analyze_results [--metrics-dir DIR] \
        [--analysis-dir DIR] [--model-dir DIR] [--data-dir DIR] \
        [--synthetic-dir DIR] [--skip-plots] [--skip-ssim] \
        [--skip-gradcam] [--cpu] ...

Writes into ``--analysis-dir``: comparison_{acc,loss,synthetic_ratio}.png
and cv_comparison.png, comparison_report.txt, ssim_distribution.png and
gradcam_{type}_{patientId}.png, in the steps and order of the JAX CLI.
SSIM and Grad-CAM run in f32 on the CUDA device unless ``--cpu`` is
given; without a CUDA device it exits 1 with a structured ``Error:``
line.
"""
from __future__ import annotations

import argparse
import sys

import torch

from xgan_torch import config


def build_parser():
    p = argparse.ArgumentParser(
        description="Analyze and compare baseline and augmented model "
                    "results (PyTorch/CUDA)")
    p.add_argument("--metrics-dir", type=str, default="./results/metrics")
    p.add_argument("--analysis-dir", type=str, default="./results/analysis")
    p.add_argument("--model-dir", type=str, default="./models")
    p.add_argument("--data-dir", type=str, default="./data/processed")
    p.add_argument("--synthetic-dir", type=str, default="./data/synthetic")
    p.add_argument("--num-ssim-real", type=int, default=100)
    p.add_argument("--num-ssim-synth", type=int, default=500)
    p.add_argument("--num-gradcam-samples", type=int, default=3)
    p.add_argument("--image-size", type=int, default=224)
    config.add_device_arg(p)
    p.add_argument("--skip-plots", action="store_true")
    p.add_argument("--skip-ssim", action="store_true")
    p.add_argument("--skip-gradcam", action="store_true")
    config.add_resnet_stages_arg(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        device = config.resolve_device(args.cpu)
    except RuntimeError as e:
        print(f"Error: {e}")
        sys.exit(1)
    if device.type == "cuda":
        # f32 means f32: cuDNN would otherwise run the convolutions in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    from xgan_torch import analysis
    from xgan_torch.utils import check_create_dir

    check_create_dir(args.analysis_dir)
    metrics_data = {}
    for prefix in analysis.PREFIXES:
        loaded = analysis.load_metrics(args.metrics_dir, prefix)
        if loaded:
            metrics_data[prefix[:-1]] = loaded
    if not metrics_data:
        print("Error: No valid metrics loaded. Aborting analysis.")
        return

    if not args.skip_plots:
        print("\nGenerating training comparison plots...")
        analysis.plot_training_comparison(metrics_data, args.analysis_dir)
        print("\nGenerating cross-validation comparison plots...")
        analysis.plot_cv_comparison(metrics_data, args.analysis_dir)

    print("\nGenerating summary report...")
    report = analysis.generate_summary_report(metrics_data,
                                              args.analysis_dir)
    print("\n" + report)

    if not args.skip_ssim:
        analysis.calculate_ssim_distribution(
            args.data_dir, args.synthetic_dir, args.analysis_dir,
            device=device, num_real_samples=args.num_ssim_real,
            num_synthetic_samples=args.num_ssim_synth,
            image_size=args.image_size)

    if not args.skip_gradcam:
        analysis.generate_grad_cam_comparison(
            args.model_dir, args.data_dir, args.synthetic_dir,
            args.analysis_dir, device=device,
            num_samples=args.num_gradcam_samples,
            image_size=args.image_size, stage_sizes=args.resnet_stages)

    print(f"\nAnalysis complete. Outputs saved to {args.analysis_dir}")


if __name__ == "__main__":
    main()
