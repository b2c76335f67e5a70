"""Device mesh and sharding rules over torch.distributed
(medplib_tpu/parallel/mesh.py).

The JAX package names a (data, expert, model) mesh and lets GSPMD insert
the collectives. Here each mesh position is one process, and the port's
model code calls the collectives itself:

- data:   batch-parallel; every rank holds its own rows of the global batch
- expert: MoE expert parallelism (ops/moe._gmm_moe_ep and the distributed
          capacity dispatches); outside the MoE blocks it is more
          batch-parallelism: rows shard over (data, expert)
- model:  tensor parallelism (parallel/tp.py): column-parallel q / k / v
          and gate / up, row-parallel o / down, vocab-sharded embedding
          and lm_head

Ranks follow make_mesh's reshape, `rank = (d * E + e) * M + m`: model
innermost, data outermost. `make_mesh` builds one process group for every
non-empty set of axes, so a collective can run over one axis or a pair.

Collectives and autograd. Every rank computes the same global loss, and
the train step differentiates loss / world size; the collectives carry
their sum adjoints (all-reduce <-> all-reduce, all-gather <->
reduce-scatter). Summing a leaf's gradient over the ranks that hold the
same copy of it then gives the one-process gradient, whatever the layout
(train/trainer.reduce_grads).

Parameter layout. `param_spec` maps a leaf's path to a spec with the JAX
package's rules, leaf for leaf (a test holds the two equal): a spec is a
tuple with one entry per dimension, an axis name or None. `shard_params`
gives each rank its slice of every leaf that `shard_spec` splits: the JAX
rule inside the language model. The JAX rule also matches the q / k / v
kernels of the CLIP tower and SAM by name; GSPMD treats that as a layout,
but the port runs those modules whole on every rank, so shard_spec keeps
them (and the projector and adapters) whole, and the packed qkv_proj /
gateup_proj kernels of pack_inference, whose rank blocks are segments of
the concatenated output axis (parallel/tp.packed_local).

Gloo serves processes that share one device, and the CPU; NCCL serves one
device per process. Gloo staging: a CUDA tensor goes through the host;
bf16 / f16 values are gathered as their bytes (a reduce-scatter too,
adding its chunks in f32 where it lands) and all-reduced in f32: exact
for the sums here, which add at most two nonzero terms, or rounded once
where they add more.
"""

from __future__ import annotations

import contextlib
import itertools
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from medplib_tpu_torch.config import MeshConfig

AXIS_DATA = "data"
AXIS_EXPERT = "expert"
AXIS_MODEL = "model"
AXIS_NAMES = (AXIS_DATA, AXIS_EXPERT, AXIS_MODEL)
# batch rows shard over (data, expert); the expert axis doubles as extra
# data parallelism outside the MoE blocks
ROWS = (AXIS_DATA, AXIS_EXPERT)


def _axes(axes) -> Tuple[str, ...]:
    """An axis name or a collection of them -> the names in mesh order."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    bad = [a for a in names if a not in AXIS_NAMES]
    if bad:
        raise ValueError(f"unknown mesh axes {bad}")
    return tuple(a for a in AXIS_NAMES if a in names)


class Mesh:
    """This process's position in a (data, expert, model) mesh, with the
    process groups of every set of axes (none for a one-process mesh
    without torch.distributed, whose collectives are identities)."""

    def __init__(self, cfg: MeshConfig, rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], Any]] = None,
                 backend: Optional[str] = None):
        self.cfg, self.rank = cfg, rank
        self.shape = {AXIS_DATA: cfg.data, AXIS_EXPERT: cfg.expert,
                      AXIS_MODEL: cfg.model}
        d, rest = divmod(rank, cfg.expert * cfg.model)
        e, m = divmod(rest, cfg.model)
        self.coords = {AXIS_DATA: d, AXIS_EXPERT: e, AXIS_MODEL: m}
        self.groups = groups or {}
        self.backend = backend

    def size(self, axes) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's position along `axes`, mixed radix in mesh order
        (for ROWS: d * E + e, its row shard of the global batch)."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    @property
    def world(self) -> int:
        return self.cfg.total

    def __repr__(self) -> str:
        return (f"Mesh(data={self.cfg.data}, expert={self.cfg.expert}, "
                f"model={self.cfg.model}, rank={self.rank}, "
                f"backend={self.backend})")

    # -- raw collectives (no autograd) -------------------------------------

    def _prep(self, x: torch.Tensor):
        """(tensor to hand the backend, its device and dtype to restore)."""
        t = x.detach()
        if self.backend == "nccl" and not t.is_cuda:
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        if self.backend == "gloo":
            if t.is_cuda:
                t = t.cpu()
            if t.dtype in (torch.bfloat16, torch.float16):
                t = t.float()
        return t.contiguous(), x.device, x.dtype

    def _raw_all_reduce(self, x, axes, op: str = "sum"):
        g = self.groups.get(_axes(axes))
        if g is None:
            return x
        t, dev, dt = self._prep(x)
        t = t.clone()
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=g)
        return t.to(device=dev, dtype=dt)

    def _raw_all_gather(self, x, axes, dim: int = 0):
        axes = _axes(axes)
        g = self.groups.get(axes)
        if g is None:
            return x
        n = self.size(axes)
        if self.backend == "gloo" and x.dtype in (torch.bfloat16,
                                                  torch.float16):
            # a gather moves bytes: send the 16-bit values as they are
            t = x.detach().movedim(dim, 0).contiguous()
            b = t.reshape(t.shape[0], -1).view(torch.uint8).cpu()
            parts = [torch.empty_like(b) for _ in range(n)]
            dist.all_gather(parts, b, group=g)
            out = torch.cat(parts, 0).to(x.device).view(x.dtype)
            return out.reshape((n * t.shape[0],) + tuple(t.shape[1:])
                               ).movedim(0, dim)
        t, dev, dt = self._prep(x.movedim(dim, 0))
        if self.backend == "gloo":
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=g)
            out = torch.cat(parts, 0)
        else:
            out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
            dist.all_gather_into_tensor(out, t, group=g)
        return out.to(device=dev, dtype=dt).movedim(0, dim)

    def _raw_reduce_scatter(self, x, axes, dim: int = 0):
        axes = _axes(axes)
        g = self.groups.get(axes)
        if g is None:
            return x
        n = self.size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"reduce-scatter of {x.shape[dim]} rows over "
                             f"{n} ranks")
        c = x.shape[dim] // n
        if self.backend == "gloo" and x.dtype in (torch.bfloat16,
                                                  torch.float16):
            # half the bytes of an f32 all-reduce: gather the 16-bit
            # values, add this rank's chunks in f32
            parts = self._raw_all_gather(x, axes, dim).movedim(dim, 0)
            parts = parts.reshape((n, n * c) + tuple(parts.shape[1:]))
            i = self.index(axes)
            out = parts[:, i * c:(i + 1) * c].float().sum(0).to(x.dtype)
            return out.movedim(0, dim).contiguous()
        t, dev, dt = self._prep(x.movedim(dim, 0))
        if self.backend == "gloo":
            t = t.clone()
            dist.all_reduce(t, group=g)
            out = t[self.index(axes) * c:(self.index(axes) + 1) * c]
        else:
            out = t.new_empty((c,) + tuple(t.shape[1:]))
            dist.reduce_scatter_tensor(out, t, group=g)
        return out.to(device=dev, dtype=dt).movedim(0, dim).contiguous()

    # -- collectives with their sum adjoints -------------------------------

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"):
        """Sum (or, without autograd, max) over `axes`."""
        if _axes(axes) not in self.groups:
            return x
        if op == "sum" and x.requires_grad and torch.is_grad_enabled():
            return _AllReduce.apply(x, self, _axes(axes))
        return self._raw_all_reduce(x, axes, op)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0):
        """Concatenate the ranks' tensors along `dim` in rank order."""
        if _axes(axes) not in self.groups:
            return x
        if x.requires_grad and torch.is_grad_enabled():
            return _AllGather.apply(x, self, _axes(axes), dim)
        return self._raw_all_gather(x, axes, dim)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int = 0):
        """Sum over `axes`, then keep this rank's chunk along `dim`."""
        if _axes(axes) not in self.groups:
            return x
        if x.requires_grad and torch.is_grad_enabled():
            return _ReduceScatter.apply(x, self, _axes(axes), dim)
        return self._raw_reduce_scatter(x, axes, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh._raw_all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._raw_all_reduce(g, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh._raw_all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._raw_reduce_scatter(g, ctx.axes, ctx.dim), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh._raw_reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._raw_all_gather(g, ctx.axes, ctx.dim), None, None,
                None)


# ---------------------------------------------------------------------------
# construction, the ambient mesh
# ---------------------------------------------------------------------------

def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: Optional[str] = None,
                     device: Optional[str] = None) -> torch.device:
    """Join the process group of `num_processes` processes whose rank 0
    listens at `coordinator` ("host:port"). The backend is NCCL on CUDA
    devices and gloo on the CPU unless `backend` says otherwise (gloo
    serves processes that share one card). Each process gets one device:
    cuda:(process_id mod device count), or the CPU. -> that device."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda",
                               process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dev


def make_mesh(cfg: MeshConfig) -> Mesh:
    """The (data, expert, model) mesh of the initialized process group
    (world size cfg.total), with a process group for every non-empty set
    of axes; without torch.distributed, a (1, 1, 1) mesh whose collectives
    are identities. Every rank must call it (new_group is collective)."""
    if not dist.is_initialized():
        if cfg.total != 1:
            raise ValueError(f"a {cfg} mesh needs {cfg.total} processes: "
                             "call init_distributed first")
        return Mesh(cfg)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != cfg.total:
        raise ValueError(f"need {cfg.total} processes, have {world}")
    shape = (cfg.data, cfg.expert, cfg.model)
    coords = list(itertools.product(*[range(n) for n in shape]))
    groups = {}
    for k in range(1, 4):
        for sub in itertools.combinations(range(3), k):
            rest = [i for i in range(3) if i not in sub]
            keys = sorted({tuple(c[i] for i in rest) for c in coords})
            for key in keys:
                ranks = [r for r, c in enumerate(coords)
                         if tuple(c[i] for i in rest) == key]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[tuple(AXIS_NAMES[i] for i in sub)] = g
    return Mesh(cfg, rank, groups, dist.get_backend())


def local_mesh() -> Mesh:
    """1-process mesh (single-device dev / bench path): no process group,
    every collective an identity."""
    return Mesh(MeshConfig(1, 1, 1))


_CURRENT: list = []


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Run the model code inside under `mesh` (jax.set_mesh's
    counterpart): its batches are this rank's rows, its params this
    rank's shards (shard_params)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> Optional[Mesh]:
    return _CURRENT[-1] if _CURRENT else None


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the row shards of the ambient mesh: a per-rank partial sum
    of the global batch -> the global sum (identity outside a mesh)."""
    mesh = current_mesh()
    return x if mesh is None else mesh.all_reduce(x, ROWS)


def row_shards() -> int:
    mesh = current_mesh()
    return 1 if mesh is None else mesh.size(ROWS)


# ---------------------------------------------------------------------------
# logical-axis -> mesh-axis rules (the JAX package's, leaf for leaf)
# ---------------------------------------------------------------------------

RULES: Dict[Optional[str], Optional[str]] = {
    "batch": AXIS_DATA,
    "vocab": AXIS_MODEL,
    "heads": AXIS_MODEL,
    "kv_heads": AXIS_MODEL,
    "mlp": AXIS_MODEL,
    "expert": AXIS_EXPERT,
    "embed": None,
    "head_dim": None,
    "conv": None,
    "spatial": None,
    None: None,
}

Spec = Tuple[Optional[str], ...]


def logical_to_spec(logical_axes: Sequence[Optional[str]]) -> Spec:
    return tuple(RULES.get(a, None) for a in logical_axes)


# Path regexes -> logical axes, first match wins, searched anywhere in the
# "/"-joined path (so "qkv_proj/kernel" matches the q/k/v rule and the
# expert kernels match the dense rules first, whose rank then fails the
# ndim test and leaves them replicated: as in the JAX package).
_PATH_RULES = [
    # LLaMA
    (r"embed_tokens/embedding$", ("vocab", "embed")),
    (r"lm_head/kernel$", ("embed", "vocab")),
    (r"(q_proj|k_proj|v_proj)/kernel$", ("heads", "embed")),
    (r"o_proj/kernel$", ("heads", "embed")),
    (r"(gate_proj|up_proj)/kernel$", ("embed", "mlp")),
    (r"down_proj/kernel$", ("mlp", "embed")),
    # MoE expert stacks carry a leading expert dim
    (r"experts/(gate_proj|up_proj)/kernel$", ("expert", "embed", "mlp")),
    (r"experts/down_proj/kernel$", ("expert", "mlp", "embed")),
    # expert quantization scales: scale [L, E, 1, N], scale4h [L, E, G, 1, N]
    (r"experts/.*/scale$", ("expert", None, None)),
    (r"experts/.*/scale4h$", ("expert", None, None, None)),
    (r"router/kernel$", ("embed", None)),
    # LoRA
    (r"lora_a$", ("embed", None)),
    (r"lora_b$", (None, "embed")),
]
_PATH_RULES_COMPILED = [(re.compile(p), ax) for p, ax in _PATH_RULES]


def param_spec(path: Sequence[str], leaf) -> Spec:
    """Spec of one parameter, by its path (a sequence of keys)."""
    s = "/".join(str(k) for k in path)
    for rx, axes in _PATH_RULES_COMPILED:
        if rx.search(s):
            ndim = leaf.dim() if hasattr(leaf, "dim") else \
                getattr(leaf, "ndim", len(axes))
            if ndim == len(axes) + 1:
                axes = (None,) + tuple(axes)   # stacked leading layer dim
            elif ndim != len(axes):
                return ()
            return logical_to_spec(axes)
    return ()   # replicated: norms, biases, vision towers, SAM


# modules the port runs replicated on every rank, whatever their names
REPLICATED_MODULES = ("clip", "sam", "mm_projector", "region_fea_adapter",
                      "region_geo_sampler", "mask_encoder",
                      "mm_token_compressor", "text_hidden_fcs")


# packed kernels (llama.pack_inference) the port keeps whole: each model
# rank narrows its q / k / v (gate / up) blocks from them (tp.packed_local)
PACKED_MODULES = ("qkv_proj", "gateup_proj")


def shard_spec(path: Sequence[str], leaf) -> Spec:
    """The spec shard_params applies: param_spec, except under
    REPLICATED_MODULES and PACKED_MODULES (whole)."""
    if any(k in REPLICATED_MODULES + PACKED_MODULES for k in path):
        return ()
    return param_spec(path, leaf)


def sharded_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a leaf with `spec` is split over."""
    return _axes([a for a in spec if a is not None])


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_leaf(mesh: Mesh, spec: Spec, leaf: torch.Tensor) -> torch.Tensor:
    """This rank's block of a whole leaf under `spec`."""
    out = leaf
    for dim, a in enumerate(spec):
        if a is None:
            continue
        n = mesh.size(a)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {out.shape[dim]} does not "
                             f"split over {n} ranks of axis {a!r}")
        c = out.shape[dim] // n
        out = out.narrow(dim, mesh.coords[a] * c, c)
    return out.contiguous() if out is not leaf else out


def shard_params(mesh: Mesh, params: Any) -> Any:
    """This rank's tree: each leaf that shard_spec splits becomes its
    block (contiguous), the others stay the same tensors. A new tree of
    containers."""
    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return shard_leaf(mesh, shard_spec(path, leaf), leaf)
    return _map_with_path(one, params)


def batch_sharding(mesh: Mesh) -> Spec:
    """Inputs shard their leading batch dim over (data, expert)."""
    return (ROWS,)


def host_local_batch_to_global(mesh: Mesh, batch: Any, dim: int = 0) -> Any:
    """Each rank takes its rows of the global batch: contiguous blocks
    along `dim` (the batch axis; 1 for batches with a leading microbatch
    axis) in row-shard order. Leaves without that axis pass through."""
    n, i = mesh.size(ROWS), mesh.index(ROWS)

    def rows(x):
        if not isinstance(x, torch.Tensor) or x.dim() <= dim:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"batch of {x.shape[dim]} rows does not split "
                             f"over {n} row shards")
        c = x.shape[dim] // n
        return x.narrow(dim, i * c, c)

    if hasattr(batch, "_fields"):
        return type(batch)(*[rows(x) for x in batch])
    return _map_with_path(lambda _, x: rows(x), batch)
