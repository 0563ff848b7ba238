"""Device meshes and parameter sharding rules (port of
`uniaudio2_tpu/parallel/mesh.py`).

The JAX package annotates its parameters with ``NamedSharding`` and lets
XLA SPMD insert the collectives. Here a mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the same three named
dimensions, one rank per device, and a parameter is a ``DTensor`` placed
by the same rules:

* ``replica``: pure data parallelism (gradients all-reduced);
* ``fsdp``: parameters and optimizer state sharded, gathered on use,
  gradients reduce-scattered;
* ``tp``: tensor parallelism over attention heads / MLP hidden units
  (Megatron column / row split, `TensorParallel`).

A spec is the JAX ``PartitionSpec`` as a plain tuple, one entry per tensor
dimension: ``None``, a mesh-dimension name, or a tuple of names (their
product shards the dimension, the first name major), with trailing
``None`` entries dropped (JAX's ``P("fsdp", None)`` is ``("fsdp",)``
here), so a test compares ``tuple(jax_spec)`` stripped of them with the
spec entry for entry. `placements` turns a spec into the DTensor placements,
one per mesh dimension; two mesh dimensions sharding one tensor dimension
split it in mesh order, replica major and fsdp minor, as JAX does.

The port's kernels take their operands whole (as JAX's SPMD partitioner
cannot shard a ``pallas_call`` either): a DTensor reaches a kernel through
`whole` / `gather` (an all-gather, or the local tensor itself where every
sharded mesh dimension has size 1), never as a shard.

Strategy mapping (the reference's ``--data-parallel {fsdp,sdp,hsdp}``):
``sdp`` -> (replica=N), ``fsdp`` -> (fsdp=N), ``hsdp`` -> (replica=A,
fsdp=B).
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("replica", "fsdp", "tp")
Spec = Tuple[Any, ...]

# a collective that waits longer than this raises instead of hanging
TIMEOUT_S = 300


def init_distributed(backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S) -> Tuple[int, int]:
    """Join the process group named by the torchrun environment
    (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``): NCCL
    on cards (``cuda:LOCAL_RANK`` becomes the current device), gloo on the
    CPU. Returns (rank, world size); a group already up is kept."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def quiet() -> None:
    """Silence DTensor's advice to flatten mesh dimensions, which it logs
    at every reduction over two of them (a batch's loss counts)."""
    import logging

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def build_mesh(*, replica: int = 1, fsdp: int = 1, tp: int = 1,
               device_type: Optional[str] = None):
    """A (replica, fsdp, tp) mesh over every rank of the process group;
    ``device_type`` defaults to cuda for an NCCL group, else cpu."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    need = replica * fsdp * tp
    if need != world:
        raise ValueError(
            f"mesh ({replica}x{fsdp}x{tp}={need}) != #devices ({world})")
    if device_type is None:
        device_type = ("cuda" if dist.is_initialized()
                       and dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, (replica, fsdp, tp),
                            mesh_dim_names=AXES)


def mesh_for_strategy(strategy: str, n_devices: Optional[int] = None,
                      replica: Optional[int] = None, tp: int = 1,
                      device_type: Optional[str] = None):
    """The mesh of a reference ``--data-parallel`` strategy name, with
    ``tp`` ranks of tensor parallelism (``n_devices // tp`` left for data
    parallelism)."""
    n = (n_devices or (dist.get_world_size() if dist.is_initialized()
                       else 1)) // tp
    if strategy == "sdp":
        return build_mesh(replica=n, tp=tp, device_type=device_type)
    if strategy == "fsdp":
        return build_mesh(fsdp=n, tp=tp, device_type=device_type)
    if strategy == "hsdp":
        r = replica or _largest_divisor_leq(n, int(math.sqrt(n)))
        return build_mesh(replica=r, fsdp=n // r, tp=tp,
                          device_type=device_type)
    raise ValueError(f"unknown data-parallel strategy: {strategy!r}")


def _largest_divisor_leq(n: int, k: int) -> int:
    for d in range(k, 0, -1):
        if n % d == 0:
            return d
    return 1


def axis_sizes(mesh) -> Dict[str, int]:
    """{mesh-dimension name: size} of a DeviceMesh (or of a mapping, which
    is returned as it is)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

_FSDP_MIN_SIZE = 2 ** 16  # don't shard tiny leaves (norm weights etc.)


def _spec(*entries) -> Spec:
    out = list(entries)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _weight_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """A leaf path's weight name and whether the leaf is a quantization
    scale: the rule keys on the enclosing weight field, not on a quantized
    container's ``values`` / ``scale`` or an unrolled layer's index."""
    parts = [p for p in path if not p.isdigit()]
    if parts and parts[-1] in ("values", "scale"):
        return (parts[-2] if len(parts) > 1 else parts[-1],
                parts[-1] == "scale")
    return (parts[-1] if parts else "", False)


def _gpt_param_spec(path: Tuple[str, ...], leaf: torch.Tensor, tp: bool
                    ) -> Spec:
    """Spec of one GPT parameter leaf: FSDP on the first true matrix
    dimension of a stacked (n_layer, in, out) leaf, TP on the output
    features of qkv / fc (column-parallel) and the input features of the
    projections (row-parallel); scales and small leaves replicated."""
    name, is_scale = _weight_name(path)
    t = "tp" if tp else None
    if is_scale or leaf.numel() < _FSDP_MIN_SIZE or leaf.ndim < 2:
        return _spec()
    if name in ("wte", "lm_head_w"):
        return _spec("fsdp", t)
    if leaf.ndim == 4:  # stacked MoE experts (L, E, in, out): experts over tp
        return _spec(None, t, "fsdp", None)
    if name == "moe_gate_w":  # router replicated on tp
        return _spec(None, "fsdp") if leaf.ndim == 3 else _spec("fsdp")
    lead = (None,) * (leaf.ndim - 2)
    if name in ("qkv_w", "fc1_w", "fc2_w"):       # column-parallel
        return _spec(*lead, "fsdp", t)
    if name in ("attn_proj_w", "mlp_proj_w"):     # row-parallel
        return _spec(*lead, t, "fsdp")
    if leaf.ndim == 3:
        return _spec(None, "fsdp")
    return _spec("fsdp")


def tree_map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and named tuples (the
    quantized containers); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    return fn(path, tree)


def _tree_map2(fn: Callable, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map2(fn, v, o) for v, o in zip(tree, other)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map2(fn, v, o) for v, o in zip(tree, other)))
    return fn(tree, other)


def unified_param_specs(params: Dict[str, Any], use_tp: bool = False):
    """Spec tree for the unified model's parameters."""
    t = "tp" if use_tp else None

    def spec_fn(path, leaf):
        name, is_scale = _weight_name(path)
        if is_scale:
            return _spec()
        if name in ("audio_embeddings", "audio_embeddings_proj"):
            return _spec("fsdp", t)
        if name == "audio_head":  # (ncb, D_dec, V_audio); list form: 2-D
            if leaf.ndim == 3:
                return _spec(None, "fsdp", t)
            return _spec("fsdp", t)
        if name == "projection_w":
            return _spec("fsdp", None)
        return _gpt_param_spec(path, leaf, use_tp)

    return tree_map_with_path(spec_fn, params)


def fit_spec_to_mesh(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Replicate every spec entry whose mesh-dimension product does not
    divide its tensor dimension (the rules are written mesh-agnostically;
    e.g. a stacked (28, D) norm under fsdp=8 falls back to replication)."""
    sizes = axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        out.append(entry if dim % math.prod(sizes[n] for n in names) == 0
                   else None)
    return _spec(*out)


def fit_specs_to_mesh(specs, params, mesh):
    """`fit_spec_to_mesh` over a spec tree aligned with ``params``."""
    return _tree_map2(lambda p, s: fit_spec_to_mesh(s, tuple(p.shape), mesh),
                      params, specs)


def batch_spec() -> Spec:
    """Input batch: rows over (replica, fsdp)."""
    return (("replica", "fsdp"),)


def placements(spec: Spec, mesh_dims: Tuple[str, ...] = AXES):
    """DTensor placements of a spec, one per mesh dimension: ``Shard(d)``
    where tensor dimension d names the mesh dimension, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_dims:
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def _local_chunk(t: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's part of a whole tensor under ``places`` (mesh order:
    the first mesh dimension splits first), as DTensor lays it out."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(places):
        if pl.is_shard() and mesh.size(i) > 1:
            t = t.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return t


def _is_whole(places, mesh) -> bool:
    return all(not pl.is_shard() or mesh.size(i) == 1
               for i, pl in enumerate(places))


def _place(t: torch.Tensor, mesh, places):
    """A whole tensor (the same on every rank) as a DTensor with
    ``places``: this rank keeps its chunk (a copy, so the whole can go; the
    tensor itself where the placement is whole)."""
    from torch.distributed.tensor import DTensor

    local = t if _is_whole(places, mesh) else \
        _local_chunk(t, mesh, places).contiguous().clone()
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """A whole tensor (the same on every rank) placed by ``spec``."""
    return _place(t, mesh, placements(spec, tuple(mesh.mesh_dim_names)))


def shard_params(params: Dict[str, Any], mesh, use_tp: bool = False):
    """Place every parameter on the mesh by the spec rules (a tree of
    DTensors, quantized containers holding DTensors)."""
    specs = fit_specs_to_mesh(unified_param_specs(params, use_tp), params,
                              mesh)
    return _tree_map2(lambda p, s: distribute(p, mesh, s), params, specs)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def shards_dim(t, dim: int) -> bool:
    """Whether a DTensor's placements shard tensor dimension ``dim`` (over
    a mesh dimension of any size)."""
    return is_dtensor(t) and any(pl.is_shard(dim) for pl in t.placements)


def whole(t):
    """The whole value of a DTensor as a plain tensor (no autograd): the
    local tensor where every sharded mesh dimension has size 1, else an
    all-gather. Anything else is returned as it is."""
    if not is_dtensor(t):
        return t
    if _is_whole(t.placements, t.device_mesh):
        return t.to_local()
    return t.full_tensor()


def whole_tree(tree):
    """`whole` over every leaf of a tree."""
    return tree_map_with_path(lambda _, t: whole(t), tree)


def gather(t, tp_partial: bool = False, dp_partial: bool = True):
    """A DTensor parameter whole, for the forward pass (autograd-aware): its
    gradient comes back summed over the data-parallel dimensions (each rank
    saw other rows: all-reduce over replica, reduce-scatter over fsdp;
    ``dp_partial=False`` when every rank saw the same rows) and over tp
    when ``tp_partial`` (each tp rank computed only its heads' or hidden
    units' share), else taken as equal on every tp rank."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate

    mesh = t.device_mesh
    grads = [Partial() if (tp_partial if n == "tp" else dp_partial)
             else Replicate() for n in mesh.mesh_dim_names]
    return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grads)


def like(value: torch.Tensor, ref):
    """A whole tensor placed as the DTensor ``ref`` (each rank keeps its
    chunk); ``value`` itself when ``ref`` is a plain tensor."""
    if not is_dtensor(ref):
        return value
    return _place(value, ref.device_mesh, ref.placements)


# ---------------------------------------------------------------------------
# Data and tensor parallelism at run time
# ---------------------------------------------------------------------------


def dp_size(mesh) -> int:
    s = axis_sizes(mesh)
    return s["replica"] * s["fsdp"]


def dp_rank(mesh) -> int:
    """This rank's index among the data-parallel shards, replica major."""
    c = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return c["replica"] * axis_sizes(mesh)["fsdp"] + c["fsdp"]


def local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch under `batch_spec`."""
    n = dp_size(mesh)
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows does not split over "
                         f"{n} data-parallel ranks")
    return x.chunk(n, dim=0)[dp_rank(mesh)]


def dp_sum(mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """A function summing a tensor over the data-parallel ranks (identity
    at one): the loss's denominators and the reported metrics."""
    if dp_size(mesh) == 1:
        return lambda x: x
    from torch.distributed.tensor import DTensor, Partial, Replicate

    places = [Replicate() if n == "tp" else Partial()
              for n in mesh.mesh_dim_names]

    def fn(x):
        return DTensor.from_local(x.detach(), mesh, places,
                                  run_check=False).full_tensor()
    return fn


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: identity forward, gradient all-reduced over tp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: partial sums all-reduced over tp, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel(NamedTuple):
    """This rank's place in its tp group. A module that runs tensor
    parallel computes ``part(n)`` of n heads / groups / hidden units (n %
    size == 0): column-parallel products give them, row-parallel products
    give partial sums that `reduce` adds up."""

    group: Any
    rank: int
    size: int

    def part(self, n: int) -> slice:
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def divides(self, *ns: int) -> bool:
        return all(n % self.size == 0 for n in ns)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToTP.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromTP.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order (no
        autograd: the serving path)."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)


def tensor_parallel(mesh) -> Optional[TensorParallel]:
    """The tp group of a mesh, or None when tp has size 1."""
    if mesh is None or axis_sizes(mesh)["tp"] == 1:
        return None
    return TensorParallel(mesh.get_group("tp"), mesh.get_local_rank("tp"),
                          axis_sizes(mesh)["tp"])
