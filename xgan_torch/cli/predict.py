"""Batch inference with a trained classifier (flags as src/predict.py).

    python -m xgan_torch.cli.predict --model-path M.{msgpack,pth,pt2} \
        --input-dir DIR [--output predictions.json] [--batch-size 64] ...

Classifies every PNG in ``--input-dir`` with a ``{prefix}resnet50.msgpack``
checkpoint of the JAX package, a reference-layout torchvision ``.pth``, or
a ``.pt2`` artifact of ``xgan_torch.cli.export_model`` (by extension; an
artifact's input size overrides ``--image-size``), and writes
``predictions.json`` with the JAX package's keys: per image the predicted
label and the positive-class probability, plus the counts.

Images are decoded with the port's store decoder and resize (on the card
with the compiled PNG row unfilter), the last batch padded to the batch
size. The host decodes batch i+1 while the device classifies batch i:
results stay on the device until the end. Runs on the CUDA device unless
``--cpu`` is given; without a CUDA device it exits 1 with a structured
``Error:`` line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from xgan_torch import config

DECODE_THREADS = 8


def build_parser():
    p = argparse.ArgumentParser(
        description="Classify a folder of chest X-ray PNGs with a trained "
                    "xgan ResNet-50 checkpoint (PyTorch/CUDA)")
    p.add_argument("--model-path", type=str, required=True,
                   help="e.g. models/baseline_resnet50.msgpack (or a "
                        "torchvision-layout .pth from the reference, or "
                        "a .pt2 artifact from xgan_torch.cli.export_model)")
    p.add_argument("--input-dir", type=str, required=True)
    p.add_argument("--output", type=str, default="predictions.json")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=224)
    config.add_device_arg(p)
    config.add_compute_dtype_arg(p)
    config.add_resnet_stages_arg(p)
    return p


def classifier_artifact(path: str, device):
    """(artifact, input size) of a ``.pt2`` classifier; raises ValueError
    for another artifact or one exported on another kind of device."""
    import torch

    from xgan_torch.io_.export import load_exported
    art = load_exported(path, device)
    ins = art.inputs
    if not (len(ins) == 1 and len(ins[0][0]) == 4
            and ins[0][1] == torch.uint8):
        raise ValueError("not a classifier artifact: expected one uint8 "
                         f"(b,s,s,3) input, got {ins}")
    return art, int(ins[0][0][1])


def load_infer(args, device):
    """The uint8 -> (labels, probs) function for ``args.model_path``;
    exits 1 with a structured error when it does not load (an artifact
    also sets ``args.image_size``)."""
    from xgan_torch.io_.export import EXT
    if args.model_path.endswith(".stablehlo"):
        print(f"Error loading serving artifact: {args.model_path}: "
              ".stablehlo needs JAX; export a .pt2 with python -m "
              "xgan_torch.cli.export_model")
        sys.exit(1)
    if args.model_path.endswith(EXT):
        try:
            art, size = classifier_artifact(args.model_path, device)
        except (OSError, RuntimeError, ValueError) as e:
            print(f"Error loading serving artifact: {e}")
            sys.exit(1)
        if size != args.image_size:
            print(f"Note: artifact takes {size}px input; overriding "
                  f"--image-size {args.image_size}")
            args.image_size = size
        return art.call
    from xgan_torch.io_.checkpoint import load_classifier_variables
    from xgan_torch.io_.export import make_classifier_infer
    from xgan_torch.models.resnet import ResNet50
    dtype = config.resolve_dtype(args.compute_dtype, device)
    model = ResNet50(2, stage_sizes=args.resnet_stages, dtype=dtype,
                     device=device)
    try:
        load_classifier_variables(args.model_path, model)
    except Exception as e:  # noqa: BLE001 — structured CLI errors
        print(f"Error loading classifier checkpoint: {e}")
        print("Ensure --model-path is a classifier .msgpack written "
              "by src/train_classifier.py, or a torchvision-layout "
              ".pth (full ResNet-50, 2-way head).")
        sys.exit(1)
    return make_classifier_infer(model.eval())


def main(argv=None) -> dict:
    """Classify and write the JSON; returns ``{"num_images", "wall_s",
    "decode_s", "imgs_per_sec"}`` (``decode_s``: host decode and resize,
    which overlaps the device's work)."""
    args = build_parser().parse_args(argv)
    try:
        device = config.resolve_device(args.cpu)
    except RuntimeError as e:
        print(f"Error: {e}")
        sys.exit(1)
    if not os.path.exists(args.model_path):
        print(f"Error: model checkpoint not found at {args.model_path}")
        sys.exit(1)
    if not os.path.isdir(args.input_dir):
        print(f"Error: input dir {args.input_dir} not found")
        sys.exit(1)
    files = sorted(f for f in os.listdir(args.input_dir)
                   if f.endswith(".png"))
    if not files:
        print(f"No PNGs found in {args.input_dir}")
        sys.exit(1)
    print(f"Classifying {len(files)} images from {args.input_dir}")
    infer = load_infer(args, device)

    import numpy as np
    import torch

    from xgan_torch.data.store import decode_all
    t0 = time.perf_counter()
    decode_s = 0.0
    batch = args.batch_size
    pending = []  # device results, fetched after the loop
    with torch.no_grad():
        for start in range(0, len(files), batch):
            chunk = files[start:start + batch]
            t1 = time.perf_counter()
            imgs = decode_all([os.path.join(args.input_dir, f)
                               for f in chunk], args.image_size,
                              DECODE_THREADS, device.type == "cuda")
            if imgs.shape[0] < batch:  # one shape; the pad is dropped
                pad = np.repeat(imgs[-1:], batch - imgs.shape[0], axis=0)
                imgs = np.concatenate([imgs, pad])
            x = torch.from_numpy(imgs)
            if device.type == "cuda":
                x = x.pin_memory().to(device, non_blocking=True)
            decode_s += time.perf_counter() - t1
            labels, probs = infer(x)
            pending.append((labels, probs, len(chunk)))
    preds, probs = [], []
    for lb, pr, n in pending:
        preds.extend(lb[:n].cpu().tolist())
        probs.extend(pr[:n].float().cpu().tolist())
    wall = time.perf_counter() - t0

    results = {
        "model": args.model_path,
        "num_images": len(files),
        "positive": int(sum(preds)),
        "negative": int(len(preds) - sum(preds)),
        "predictions": [
            {"file": f, "label": int(lb), "prob_positive": round(pp, 6)}
            for f, lb, pp in zip(files, preds, probs)],
    }
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(f"{results['positive']}/{len(files)} predicted positive; "
          f"wrote {args.output}")
    return {"num_images": len(files), "wall_s": wall, "decode_s": decode_s,
            "imgs_per_sec": len(files) / wall}


if __name__ == "__main__":
    main()
