"""PyTorch/CUDA port of xgan, built slice by slice beside the JAX package.

The JAX package ``xgan`` is the reference; this package never imports it
(nor jax/flax), so it runs on a host that has only torch. Each module
mirrors its counterpart's path under ``xgan/``. Entry points run on CUDA
unless the caller asks for the CPU (``--cpu`` / ``device="cpu"``).

Ported so far: the DCGAN sampler (eval-mode generator on the hand-written
ConvT(k4,s2,p1)+affine+act kernel, ``xgan_torch.kernels.convt``) and the
ResNet-50 classifier trainer with its three strategies and k-fold CV
(augmented and curriculum batches on the hand-written mixed-source gather
kernel, ``xgan_torch.kernels.gather``).
"""
