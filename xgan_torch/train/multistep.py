"""``--steps-per-call K``: K consecutive train steps per call
(role of the ``steps_per_call`` form of xgan/train/gan.py, ``multi``).

The JAX package scans K steps inside one jitted program. Here, on CUDA,
K steps are captured once as one CUDA graph and replayed for every later
chunk of K full batches:

- the first call runs its K steps eagerly (on a side stream, as PyTorch's
  capture recipe asks). It is the warm-up that capture needs (the
  optimizers' state, cuBLAS and cuDNN handles exist afterwards), and it is
  real training: nothing runs that K = 1 would not run;
- the second call captures ``step`` K times on a static ``(K, B)`` index
  buffer and static copies of the call's other device inputs (the CGAN
  step's epoch, which its gate reads), the metrics stacked into a static
  ``(K, M)`` tensor. Capture runs nothing on the device; the call then
  copies its indices and inputs into those buffers, replays the graph and
  returns a clone of the metrics; every later call does the same, so a
  graph captured at one epoch reads the epoch of each later call;
- the step-draw generator is registered with the graph, so each replay
  draws from the generator's current offset and advances it as K eager
  steps would;
- a capture that fails raises: there is no eager fallback.

A step in the graph must not sync with the host, and what it allocates
must not depend on the data: the GAN trainers build Adam
``capturable=True`` on CUDA (for every K, so that K = 1 and K > 1 train
alike), the EMA and optimizer state exist before capture, and the constants the
step needs are already on the device.

Across ranks on NCCL the graph holds the step's collectives: data
parallelism's all-reduces and, under ``--model-parallel``, tensor
parallelism's all-reduces and all-gathers over the model group, captured
in the order every rank issues them. A gloo group cannot be captured
(the CLIs refuse K > 1 there).

On the CPU (tests, ``--cpu``) a call is a plain loop of K steps.

The kernels' wrappers count a launch where they launch, in Python, so a
replay that launches a captured kernel runs no wrapper. Each wrapper
call during capture records one kernel node into the graph, so the
dispatcher takes the counts the wrappers made while they were being
captured as the launches of one replay (capture itself launches
nothing, so it takes them back out of ``kernels.LAUNCHES``), and adds them
to ``kernels.LAUNCHES`` at every replay. It keeps its own ``replays`` and
``launches_per_replay``, which a check can hold against a profiler trace
of one replay.
"""
from __future__ import annotations

from collections import Counter

import torch

from xgan_torch import kernels


class StepsPerCall:
    def __init__(self, step, k: int, generator: torch.Generator):
        """``step(idx, *inputs) -> (M,) metrics``: one full train step on a
        (B,) index tensor and the call's other device ``inputs`` (the EMA
        update included). ``generator``: the one the step draws from."""
        self.step = step
        self.k = k
        self.generator = generator
        self.calls = 0
        self.replays = 0
        self.launches_per_replay: Counter = Counter()
        self.graph = None
        self._inputs = None
        self._out = None

    def _eager(self, idx_chunk: torch.Tensor, *inputs) -> torch.Tensor:
        return torch.stack([self.step(idx_chunk[t], *inputs)
                            for t in range(self.k)])

    def __call__(self, idx_chunk: torch.Tensor, *inputs) -> torch.Tensor:
        """Run K steps on ``idx_chunk`` (K, B) and the device tensors
        ``inputs``, the same for each of the K steps; returns the (K, M)
        metrics."""
        if idx_chunk.shape[0] != self.k:
            raise ValueError(f"expected {self.k} batches, got "
                             f"{idx_chunk.shape[0]}")
        self.calls += 1
        if idx_chunk.device.type != "cuda":
            return self._eager(idx_chunk, *inputs)
        if self.calls == 1:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = self._eager(idx_chunk, *inputs)
            torch.cuda.current_stream().wait_stream(side)
            return out
        if self.graph is None:
            self._capture(idx_chunk, inputs)
        for buf, x in zip(self._inputs, (idx_chunk, *inputs)):
            buf.copy_(x)
        self.graph.replay()
        self.replays += 1
        kernels.LAUNCHES.update(self.launches_per_replay)
        return self._out.clone()

    def _capture(self, idx_chunk: torch.Tensor, inputs) -> None:
        self._inputs = [x.clone() for x in (idx_chunk, *inputs)]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = Counter(kernels.LAUNCHES)
        # thread_local: the snapshot writer thread may use CUDA meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._out = self._eager(*self._inputs)
        captured = Counter(kernels.LAUNCHES)
        captured.subtract(before)
        self.launches_per_replay = +captured
        kernels.LAUNCHES.clear()
        kernels.LAUNCHES.update(before)
        self.graph = graph
