"""The model-axis shape rule, ``--model-parallel`` on a world it does not
divide, and ZeRO-1 Adam moments over the ranks (role of
xgan/parallel/tp.py).

The JAX package shards a leaf over its mesh's ``model`` axis when the
leaf's rule dimension is at least ``min_features`` (256, ``MIN_FEATURES``)
and divisible by the axis size (:func:`model_axis_spec`): a conv kernel's
O in HWIO, a dense kernel's I in (I, O), a per-channel vector's only
dimension. The port holds torch layouts, so :func:`shard_dim` maps the
rule onto them by the module that owns the leaf:

- ``nn.Conv2d.weight`` (O, I, kh, kw): dimension 0;
- ``nn.ConvTranspose2d.weight`` (I, O, kh, kw): dimension 1;
- ``nn.Linear.weight`` (O, I): dimension 1, the dense rule's I;
- ``nn.Embedding.weight`` (N, D), as flax's ``Embed``: dimension 0;
- 1-D leaves (biases, BN's scale and shift): dimension 0.

``--shard-opt-state`` (:func:`shard_opt_state`, ZeRO-1) applies the rule
with the axis set to every rank: each rank keeps the Adam moments of its
slice of each wide parameter, and the narrow ones and every step count
whole. :class:`ShardedAdam` steps a ``torch.optim.Adam`` over those
slices (the same arithmetic and options, ``capturable`` on CUDA
included) in place in the parameters: a slice on a parameter's first
dimension is a view of it, and another slice (a transposed conv's or a
dense layer's) and its gradient are copied into dense tensors for the
step only, so that every tensor Adam sees is dense, as the replicated
run's are, and takes the same multi-tensor arithmetic. Then every
updated parameter is assembled on every rank, in buckets of at most
``BUCKET`` elements of slices: NCCL's ``all_gather_into_tensor``, or on
gloo an all-reduce of a zero buffer holding each rank's slices at its
own place (``x + 0`` is exact). Adam is element-wise, so the parameters
stay bitwise those of the replicated run. What the optimizer keeps
between steps is its state alone (:func:`state_bytes`). Its
``state_dict`` assembles the moments whole, in the layout
``torch.optim.Adam`` writes (a collective: every rank calls it), and
``load_state_dict`` takes such a whole state and keeps its slices.

``--model-parallel N`` with N > 1 dividing the ranks is tensor
parallelism across ranks on the JAX package's ``(data, model)`` layout
(:meth:`~xgan_torch.parallel.mesh.MeshContext.split_model`): the rule
with the axis set to the N ranks of a model group places each wide leaf's
slice on its rank (:func:`shard_over_model`: the parameters, BN's running
statistics of a shardable width, and so Adam's moments), and the models
compute each wide conv and ConvT column-parallel, its output channels
split over the model group, as the flag's help says:

- activations flow channel-sliced until a layer needs all channels (a
  narrow layer, the next column-parallel layer, a head), where
  :func:`gather_from_model` assembles them (:func:`layer_input`); BN on a
  slice is exact, its moments over the data group; ResNet's residual
  adds slice to slice (conv3 and the downsample share one O split) and
  its ``fc`` is row-parallel: each rank's partial product over its slice
  of the pooled features, summed by :func:`reduce_from_model`, then the
  bias once;
- :func:`copy_to_model` marks the input of a column-parallel layer: the
  identity forward, whose backward sums the partial input gradients of
  the ranks' columns over the model group. A tensor that is the same on
  every rank of the group so carries the same gradient on every rank,
  and ``gather`` then ``copy`` is a reduce-scatter in the backward. Each
  operator's backward is made of the others (split, the backward of
  gather, is one too), so that a double backward sees every collective;
- the data group carries every collective of data parallelism (rows, BN
  moments, losses, gradients), so the N ranks of a model group see the
  same rows and count their loss once; the replicated parameters'
  gradients are broadcast from the group's first rank
  (:func:`~xgan_torch.parallel.mesh.all_reduce_grads`), so that their
  copies stay bitwise equal.

What computes column-parallel, model by model: the DCGAN and WGAN-GP
generators' first ConvT (packed from its slice) and their wide k4s2
ConvTs (the kernel on each rank's slice of Cout), the DCGAN
discriminator's and the WGAN-GP critic's wide convs (the critic's under
the gradient penalty's double backward), the CGAN generator's and
discriminator's wide convs with their biases, and ResNet-50's wide convs
(its ``fc`` row-parallel). The CGAN generator's ``fc`` is the one layer
whose bias the rule slices without its weight (a dense kernel's rule
dimension is its I, the latent; the bias's is its C*S0*S0 outputs): every
rank computes all of its outputs and adds the bias gathered whole. The
CGAN discriminator's feature-matching taps of a sliced layer are gathered
whole, so that its loss is one process's. The frozen VGG16 of the CGAN's
perceptual loss is never placed: it stays whole on every rank, as the JAX
loop replicates it.

The ranks of a model group must issue their collectives in the same
order. A forward does so by construction; a backward runs its nodes in
the order of their sequence numbers, which autograd counts per thread.
A double backward (the WGAN-GP penalty's) would mix nodes that the
forward made on the calling thread with nodes that the first backward
made on the device's autograd thread, whose two counts differ by each
rank's own history. So a placed critic's penalty and the backward
through it run under :func:`one_autograd_thread`: every node is then
made and run on the calling thread, numbered by one count, and the
ranks agree on the order whatever autograd work each ran before.

Checkpoints, snapshots and the EMA are written whole, in the reference
layouts (:func:`whole_state_dict`, :func:`whole_opt_state_dict`, each a
collective of the model group), and
a resume cuts them again (:func:`load_whole`,
:func:`opt_state_for_load`), as the JAX loops re-place a restored state.
ZeRO-1 composes on top: a wide moment sharded over ``(model, data)`` is a
slice of the rank's TP slice split over its data group
(:func:`shard_opt_state`, the rule on the whole shape over every rank).

:func:`model_parallel_from_args` prints the JAX package's note and trains
replicated for every N that does not divide the ranks.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

MIN_FEATURES = 256  # ResNet-50: shards stages conv3_x..conv5_x + fc
BUCKET = 1 << 22  # elements of slices a ZeRO-1 all-gather assembles


def model_axis_spec(shape, model_size: int,
                    min_features: int = MIN_FEATURES) -> int | None:
    """The dimension of a leaf of the JAX package's layout (HWIO conv
    kernels, (I, O) dense kernels, per-channel vectors) that the rule
    shards over an axis of ``model_size``, or None (replicated)."""
    def ok(dim):
        return dim >= min_features and dim % model_size == 0

    if len(shape) == 4 and ok(shape[3]):
        return 3
    if len(shape) in (1, 2) and ok(shape[0]):
        return 0
    return None


def _rule_dim(module: nn.Module, name: str, t: torch.Tensor) -> int | None:
    """The torch dimension that holds the JAX rule's dimension of
    ``module``'s leaf ``name`` (see the module docstring)."""
    if t.dim() == 1:
        return 0
    if name != "weight":
        return None
    if isinstance(module, nn.ConvTranspose2d) or (
            isinstance(module, nn.Linear) and t.dim() == 2):
        return 1
    if isinstance(module, (nn.Conv2d, nn.Embedding)):
        return 0
    return None


def shard_dim(module: nn.Module, name: str, t: torch.Tensor, n: int,
              min_features: int = MIN_FEATURES) -> int | None:
    """The dimension of ``module``'s leaf ``name`` (``t``) sharded over
    ``n`` ranks, or None (replicated)."""
    d = _rule_dim(module, name, t)
    if d is None or t.shape[d] < min_features or t.shape[d] % n:
        return None
    return d


def shard_dims(models, n: int, min_features: int = MIN_FEATURES) -> dict:
    """``{parameter: sharded dimension or None}`` of every parameter of
    ``models`` (modules) over ``n`` ranks, the rule applied to each
    parameter's whole shape (a tensor-parallel slice's too)."""
    out = {}
    for model in models:
        for module in model.modules():
            for name, p in module.named_parameters(recurse=False):
                out[p] = shard_dim(module, name, _whole(p), n, min_features)
    return out


def _whole(p: torch.Tensor) -> torch.Tensor:
    """``p``, or a meta tensor of its whole shape when it is a slice
    (:func:`shard_over_model`)."""
    d = getattr(p, "tp_dim", None)
    if d is None:
        return p
    shape = list(p.shape)
    shape[d] *= p.tp_size
    return torch.empty(shape, device="meta")


# ---- tensor parallelism: the operators ----

def _active(model) -> bool:
    return model is not None and model.distributed and model.world > 1


def _gather(x: torch.Tensor, model, dim: int) -> torch.Tensor:
    """Every rank's slice of ``x`` along ``dim``, concatenated in rank
    order (no autograd). The gathered dimension is made the innermost
    first (free for NHWC and for a channels_last NCHW tensor's channels),
    so that the result keeps ``x``'s memory format."""
    y = x.movedim(dim, -1).contiguous()
    every = model.all_gather(y)  # (n, ..., c)
    n, c = every.shape[0], y.shape[-1]
    return every.movedim(0, -2).reshape(*y.shape[:-1], n * c) \
        .movedim(-1, dim)


def _split(x: torch.Tensor, model, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (a copy in ``x``'s
    memory format)."""
    k = x.shape[dim] // model.world
    return x.movedim(dim, -1).narrow(-1, model.rank * k, k).contiguous() \
        .movedim(-1, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model):
        ctx.model = model
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromModel.apply(g, ctx.model), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model):
        ctx.model = model
        return model.all_reduce_(x.clone(
            memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return _CopyToModel.apply(g, ctx.model), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model, dim):
        ctx.model, ctx.dim = model, dim
        return _gather(x, model, dim)

    @staticmethod
    def backward(ctx, g):
        return _SplitToModel.apply(g, ctx.model, ctx.dim), None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model, dim):
        ctx.model, ctx.dim = model, dim
        return _split(x, model, dim)

    @staticmethod
    def backward(ctx, g):
        return _GatherFromModel.apply(g, ctx.model, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, model) -> torch.Tensor:
    """f: the input of a column-parallel layer, the same on every rank of
    the model group ``model``; identity, and a SUM all-reduce of the
    gradient over the group in the backward."""
    return _CopyToModel.apply(x, model) if _active(model) else x


def reduce_from_model(x: torch.Tensor, model) -> torch.Tensor:
    """g: the partial products of a row-parallel layer summed over the
    model group; identity in the backward."""
    return _ReduceFromModel.apply(x, model) if _active(model) else x


def gather_from_model(x: torch.Tensor, model, dim: int) -> torch.Tensor:
    """The ranks' channel slices ``x`` (along ``dim``) as all channels,
    on every rank of the model group; the backward keeps this rank's
    slice of the gradient."""
    return _GatherFromModel.apply(x, model, dim) if _active(model) else x


def split_to_model(x: torch.Tensor, model, dim: int) -> torch.Tensor:
    """This rank's channel slice of ``x`` (the same on every rank of the
    group); the backward gathers the slices' gradients."""
    return _SplitToModel.apply(x, model, dim) if _active(model) else x


def sharded(p: torch.Tensor) -> bool:
    """``p`` is a parameter's tensor-parallel slice."""
    return getattr(p, "tp_dim", None) is not None


def layer_input(x: torch.Tensor, cin: int, model, column: bool,
                dim: int = 1) -> torch.Tensor:
    """``x`` as the input of a layer of ``cin`` input channels (along
    ``dim``): all channels, gathered when ``x`` holds a slice of them;
    through :func:`copy_to_model` when the layer is column-parallel
    (``column``: its weight is a slice)."""
    if x.shape[dim] != cin:
        x = gather_from_model(x, model, dim)
    return copy_to_model(x, model) if column else x


# ---- tensor parallelism: placement, and the whole state ----

def _sliced_buffers(module: nn.Module) -> tuple:
    """The buffers of ``module`` sliced with its parameters: a BN's
    running statistics when its scale is a slice."""
    if isinstance(module, nn.BatchNorm2d) and sharded(module.weight):
        return ("running_mean", "running_var")
    return ()


@torch.no_grad()
def shard_over_model(models, model, min_features: int | None = None
                     ) -> None:
    """Place ``models`` (modules, whole on every rank) for tensor
    parallelism over the model group ``model``, in place: each parameter
    the rule shards over ``model.world`` ranks (the width
    ``min_features``, ``MIN_FEATURES`` as it stands when called) keeps
    this rank's slice, tagged ``tp_dim`` and ``tp_size``, and so do a
    sliced BN's running statistics; each model and its submodules record
    ``tp`` (the group), each model ``tp_dims`` (``{state-dict key: sliced
    dimension}``), and a model with a ``repack`` (the generator's eval
    tensors) repacks. Call it before the optimizers and the EMA are made.
    A no-op over one rank."""
    if not _active(model):
        return
    width = MIN_FEATURES if min_features is None else min_features
    n, r = model.world, model.rank
    for m in models:
        dims = {}
        for prefix, module in m.named_modules():
            pre = f"{prefix}." if prefix else ""
            for name, p in module.named_parameters(recurse=False):
                d = shard_dim(module, name, p, n, width)
                if d is None:
                    continue
                k = p.shape[d] // n
                p.data = p.data.narrow(d, r * k, k).clone()
                p.tp_dim, p.tp_size, p.tp_model = d, n, model
                dims[pre + name] = d
            for name in _sliced_buffers(module):
                buf = getattr(module, name)
                k = buf.shape[0] // n
                setattr(module, name, buf.narrow(0, r * k, k).clone())
                dims[pre + name] = 0
        for module in m.modules():  # the blocks read it too
            module.tp = model
        m.tp_dims = dims
        if hasattr(m, "repack"):
            m.repack()


def _group_of(m: nn.Module):
    return getattr(m, "tp", None) if _active(getattr(m, "tp", None)) \
        else None


def one_autograd_thread(m: nn.Module):
    """A context in which autograd makes and runs every node on the
    calling thread (``torch.autograd.set_multithreading_enabled(False)``)
    when ``m`` is placed over a model group, and a no-op otherwise. A
    double backward through ``m`` then orders its model-group collectives
    by one thread's sequence numbers, the same on every rank of the
    group (see the module docstring)."""
    if _group_of(m) is None:
        return contextlib.nullcontext()
    return torch.autograd.set_multithreading_enabled(False)


def whole_state_dict(m: nn.Module, sd: dict | None = None) -> dict:
    """``sd`` (default ``m.state_dict()``; or any ``{name: tensor}`` keyed
    by ``m``'s names, such as its EMA) with each slice assembled whole: a
    collective of ``m``'s model group under tensor parallelism, the
    reference layout."""
    sd = m.state_dict() if sd is None else dict(sd)
    model = _group_of(m)
    if model is None:
        return sd
    return {k: (_gather(v.detach(), model, m.tp_dims[k])
                if k in m.tp_dims else v) for k, v in sd.items()}


def slice_state(m: nn.Module, sd: dict) -> dict:
    """A whole state dict (``{name: tensor}``) cut to this rank's slices
    of ``m`` (itself without tensor parallelism)."""
    model = _group_of(m)
    if model is None:
        return sd
    out = dict(sd)
    for k, d in m.tp_dims.items():
        if k in out:
            k_ = out[k].shape[d] // model.world
            out[k] = out[k].narrow(d, model.rank * k_, k_).clone()
    return out


def load_whole(m: nn.Module, sd: dict, strict: bool = True):
    """``m.load_state_dict`` of a whole (reference-layout) state dict,
    cut to this rank's slices first under tensor parallelism."""
    return m.load_state_dict(slice_state(m, sd), strict=strict)


def _opt_params(opt) -> list:
    """The parameters of ``opt`` (an Adam or a :class:`ShardedAdam`) in
    the order of its state dict's indices."""
    if isinstance(opt, ShardedAdam):
        return opt.params
    return [p for g in opt.param_groups for p in g["params"]]


def _moments(opt, sd: dict, fn) -> dict:
    """``sd`` (``opt``'s state dict layout) with ``fn(tensor, p)`` applied
    to each moment of each tensor-parallel slice ``p``."""
    params = _opt_params(opt)
    state = dict(sd["state"])
    for i, p in enumerate(params):
        if sharded(p) and i in state:
            st = dict(state[i])
            for key in ("exp_avg", "exp_avg_sq"):
                st[key] = fn(st[key], p)
            state[i] = st
    return {"state": state, "param_groups": sd["param_groups"]}


def _model_of(opt):
    for p in _opt_params(opt):
        if sharded(p):
            return p.tp_model
    return None


def whole_opt_state_dict(opt) -> dict:
    """``opt.state_dict()`` with the moments of every tensor-parallel
    slice assembled whole (a collective of every rank: the model group's,
    and a :class:`ShardedAdam`'s data group's): the state dict of
    ``torch.optim.Adam`` over the whole parameters."""
    sd = opt.state_dict()
    model = _model_of(opt)
    if model is None:
        return sd
    return _moments(opt, sd, lambda t, p: _gather(t, model, p.tp_dim))


def opt_state_for_load(opt, sd: dict) -> dict:
    """A whole optimizer state dict (:func:`whole_opt_state_dict`'s)
    with the moments of every tensor-parallel slice cut to this rank's,
    ready for ``opt.load_state_dict``."""
    model = _model_of(opt)
    if model is None:
        return sd

    def cut(t, p):
        k = t.shape[p.tp_dim] // model.world
        return t.narrow(p.tp_dim, model.rank * k, k).clone()

    return _moments(opt, sd, cut)


def rank_bytes(models, opts=()) -> int:
    """The bytes this rank keeps of ``models``' parameters and of
    ``opts``' state (:func:`state_bytes`): a count from the tensors'
    shapes."""
    return (sum(p.nbytes for m in models for p in m.parameters())
            + sum(state_bytes(o) for o in opts))


def model_parallel_from_args(args, world: int) -> int:
    """``--model-parallel N`` against the ``world`` ranks of the run (1
    without a launch): 1 when N <= 1, or after the JAX package's note
    when N does not divide them (training replicated); N when it
    does."""
    n = getattr(args, "model_parallel", 1) or 1
    if n <= 1:
        return 1
    if world % n:
        print(f"Note: --model-parallel {n} does not divide the {world} "
              f"available device(s); training with replicated params.")
        return 1
    return n


class ShardedAdam:
    """ZeRO-1: ``opt`` (a ``torch.optim.Adam`` with no state yet) with the
    moments of each wide parameter kept for this rank's slice only (see
    the module docstring). ``dims``: ``{parameter: sharded dimension or
    None}``; ``mesh``: the joined ranks. ``zero_grad``, ``step``,
    ``state_dict`` and ``load_state_dict`` as the optimizer's, and
    ``param_groups`` and ``state``: those of the Adam over the slices."""

    def __init__(self, opt: torch.optim.Adam, dims: dict, mesh):
        self.mesh = mesh
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.wide = []  # (parameter, the Adam's tensor of its slice, dim)
        groups = []
        for group in opt.param_groups:
            slices = []
            for p in group["params"]:
                d = dims.get(p)
                if d is None:
                    slices.append(p)
                    continue
                # a tensor of its own, pointed at the slice (set_), that
                # keys the slice's state in the Adam
                s = torch.empty(0, dtype=p.dtype, device=p.device)
                s.set_(self._slice(p.detach(), d))
                self.wide.append((p, s, d))
                slices.append(s)
            groups.append({**group, "params": slices})
        self.inner = torch.optim.Adam(groups)

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def _slice(self, t: torch.Tensor, d: int) -> torch.Tensor:
        k = t.shape[d] // self.mesh.world
        return t.narrow(d, self.mesh.rank * k, k)

    @torch.no_grad()
    def step(self, step=None) -> None:
        """One Adam step of this rank's slices (``step(inner)`` runs it
        instead of ``inner.step()``: the CGAN's gated step), then every
        updated parameter assembled on every rank. The slices are taken
        from the parameters at each step (a resume may have loaded them
        anew), views where dense, else dense copies for this step."""
        for p, s, d in self.wide:
            s.set_(self._slice(p.detach(), d).contiguous())
            s.grad = None if p.grad is None \
                else self._slice(p.grad, d).contiguous()
        if step is None:
            self.inner.step()
        else:
            step(self.inner)
        self._assemble()
        for p, s, d in self.wide:  # drop the step's copies
            s.grad = None
            s.set_(self._slice(p.detach(), d))

    def _buckets(self):
        """The wide parameters in runs of at most ``BUCKET`` elements of
        slices (a larger slice alone)."""
        bucket, size = [], 0
        for item in self.wide:
            if bucket and size + item[1].numel() > BUCKET:
                yield bucket
                bucket, size = [], 0
            bucket.append(item)
            size += item[1].numel()
        if bucket:
            yield bucket

    def _assemble(self) -> None:
        n = self.mesh.world
        for bucket in self._buckets():
            every = self.mesh.all_gather(
                torch.cat([s.reshape(-1) for _, s, _ in bucket]))
            offset = 0
            for p, s, d in bucket:
                part = every[:, offset:offset + s.numel()]
                # every rank's slice at its place: p as (..., n, k, ...)
                p.detach().unflatten(d, (n, s.shape[d])).copy_(
                    part.reshape(n, *s.shape).movedim(0, d))
                offset += s.numel()

    @torch.no_grad()
    def state_dict(self) -> dict:
        """``torch.optim.Adam``'s state dict of the whole parameters (a
        collective of every rank: the wide moments are assembled)."""
        sd = self.inner.state_dict()
        index = {id(s): i for i, s in enumerate(
            p for g in self.inner.param_groups for p in g["params"])}
        state = dict(sd["state"])
        for p, s, d in self.wide:
            i = index[id(s)]
            if i not in state:
                continue
            st = dict(state[i])
            for key in ("exp_avg", "exp_avg_sq"):
                every = self.mesh.all_gather(st[key].contiguous())
                st[key] = torch.cat(list(every.unbind(0)), dim=d)
            state[i] = st
        return {"state": state, "param_groups": sd["param_groups"]}

    def shard_state_dict(self, sd: dict) -> dict:
        """A whole state dict (:meth:`state_dict`'s, or ``torch.optim.
        Adam``'s of the replicated run) cut to this rank's slices."""
        index = {id(s): i for i, s in enumerate(
            p for g in self.inner.param_groups for p in g["params"])}
        state = dict(sd["state"])
        for _, s, d in self.wide:
            i = index[id(s)]
            if i in state:
                st = dict(state[i])
                for key in ("exp_avg", "exp_avg_sq"):
                    st[key] = self._slice(st[key], d).clone()
                state[i] = st
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(self.shard_state_dict(sd))


def state_bytes(opt) -> int:
    """The bytes of every tensor of ``opt``'s state on this rank (the
    moments and the step counts): what an Adam or a :class:`ShardedAdam`
    keeps between steps."""
    return sum(v.nbytes for st in opt.state.values() for v in st.values()
               if torch.is_tensor(v))


def shard_opt_state(opt: torch.optim.Adam, models, mesh,
                    min_features: int | None = None):
    """``--shard-opt-state``: ``opt`` as a :class:`ShardedAdam` over the
    ranks of ``mesh`` for the parameters of ``models`` (the rule's width
    ``min_features``, ``MIN_FEATURES`` as it stands when called), or
    ``opt`` itself at world 1 (nothing to shard over, as the JAX package
    returns the state unchanged on one device)."""
    if mesh is None or not mesh.distributed or mesh.world == 1:
        return opt
    width = MIN_FEATURES if min_features is None else min_features
    # under tensor parallelism the rule's axis is every rank, (model,
    # data), on the whole shapes; each rank's moment is then its slice of
    # its TP slice over the data group
    n = mesh.world * (mesh.model.world if mesh.model is not None else 1)
    zero = ShardedAdam(opt, shard_dims(models, n, width), mesh)
    print(f"ZeRO-1: the Adam moments of {len(zero.wide)} of "
          f"{len(zero.params)} parameters split over {mesh.world} ranks")
    return zero


def opt_from_args(args, opt: torch.optim.Adam, models, mesh):
    """``opt``, sharded by :func:`shard_opt_state` when the trainer's
    ``args`` ask for ``--shard-opt-state``."""
    if not getattr(args, "shard_opt_state", False):
        return opt
    return shard_opt_state(opt, models, mesh)
