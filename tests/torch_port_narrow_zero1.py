"""A trainer CLI of xgan_torch with ZeRO-1's width rule lowered to 8
features, so that the tests' narrow nets have wide parameters to shard
(``MIN_FEATURES`` is 256: at 8 feature maps nothing would be).

``python -m tests.torch_port_narrow_zero1 xgan_torch.cli.train_gan
ARGS...``, from the repository's root, runs the CLI's ``main`` on ARGS.
"""
import importlib
import sys

from xgan_torch.parallel import tp

NARROW = 8

if __name__ == "__main__":
    tp.MIN_FEATURES = NARROW
    importlib.import_module(sys.argv[1]).main(sys.argv[2:])
