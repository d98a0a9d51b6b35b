"""Data parallelism over ``torch.distributed`` (``detjax/parallel/mesh.py``).

detjax builds a ``Mesh(('data',))`` over its chips, replicates the state
(``P()``), shards the batch's leading dimension on ``data`` and lets XLA
insert the gradient all-reduce into one compiled step. Here each process
holds one device and its own shard of the batch, and the step does by hand
what the partitioner does there, so that the step at world size W computes
the single-process step on the global batch:

- the trainable gradients are summed across the group in one coalesced
  all-reduce and divided by W, the data axis' length
  (``train/step.py::average_gradients``); the
  model is not wrapped in ``DistributedDataParallel``, so its state-dict
  keys, checkpoints and fused autograd functions stay as they are;
- the step's metrics are averaged the same way, so that the plateau
  controller takes one decision on every rank;
- the flip mask is drawn for the global batch and each rank takes its rows;
- batch-statistics BatchNorm reduces its sums over the group
  (``models/resnet.py::batch_stats_group``), as flax's BatchNorm under
  pjit normalises over the global batch.

A :class:`Mesh` takes one of two forms:

- **multi-process** (training, and evaluation): the data axis is the
  process group's ranks, one device a process. ``make_mesh`` adopts an
  initialised default group, or initialises one from torchrun's
  variables (NCCL on CUDA, gloo on the CPU);
- **single-process** (serving and evaluation): the data axis is this
  process's devices; each holds a replica of the model and detects its
  slice of every batch.

Spatial partitioning (``make_mesh(spatial=S)``, detjax's 2-D ``(data,
space)`` mesh) is multi-process. Rank r has data index ``r // S`` and
space index ``r % S``, detjax's grid ``reshape(-1, spatial)``. The S ranks
of a data index (its **space group**) split the same images by rows: each
takes its data index's images (``local_rows``) cut to its own block of rows
(``image_rows``), and the model exchanges halo rows and gathers over the
space group (``models/spatial.py``). The ranks of a space index (its **data
group**) hold different images: the sharded evaluation gathers its
detections over it. Batch-statistics BatchNorm sums over every rank, data
times space, and the gradients are summed over every rank and divided by
the data-axis size (``train/step.py``). A single-process mesh cannot
exchange halos without running its shards in parallel, so serving over a
space axis, and the int8 and program engines on one, are not ported
(ROADMAP Queue 1 #8): they raise.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from detjax_torch.config import Config
from detjax_torch.modeling import resolve_device
from detjax_torch.models import spatial
from detjax_torch.ops.nms import Detections
from detjax_torch.train.step import TrainState, train_step

SPACE_SERVING_NOT_PORTED = (
    "a 'space' mesh axis runs multi-process only (one rank a device under "
    "torch.distributed: fit, the train step, evaluate with the live model "
    "and --spatial K); serving over a space axis (DetectionServer(mesh=), "
    "a single-process mesh) and the int8 and program engines on a space "
    "mesh are not ported yet (ROADMAP Queue 1 #8)")

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axes of a data-parallel (and spatially partitioned) run.

    ``devices``: this process's devices (one in a multi-process mesh);
    ``group``: the process group of every rank, None in a single-process
    mesh; ``rank`` and ``world_size``: this process's place in it (0 and 1
    in one process); ``axis_name``: the data axis's name. ``space``: the
    ranks that split an image's rows (1 without a ``space`` axis, which
    :attr:`axis_names` then leaves out); ``space_group`` and
    ``data_group``: the process groups of this rank's data index (its S
    ranks) and of its space index (the data axis' ranks that share it),
    None without a ``space`` axis."""

    devices: Tuple[torch.device, ...]
    group: Any = None
    rank: int = 0
    world_size: int = 1
    axis_name: str = "data"
    space: int = 1
    space_group: Any = None
    data_group: Any = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The mesh's axes: the data axis, then "space" where it has one."""
        return (self.axis_name,) + (("space",) if self.space > 1 else ())

    @property
    def size(self) -> int:
        """The number of devices: processes times their devices."""
        return self.world_size * len(self.devices)

    @property
    def data_size(self) -> int:
        """The length of the data axis: the devices over ``space``."""
        return self.size // self.space

    @property
    def data_rank(self) -> int:
        """This rank's data index (the images it holds)."""
        return self.rank // self.space

    @property
    def space_rank(self) -> int:
        """This rank's space index (its block of every image's rows)."""
        return self.rank % self.space

    def space_context(self):
        """The ``models.spatial.SpaceGroup`` of this rank, None without a
        ``space`` axis."""
        if self.space == 1:
            return None
        return spatial.SpaceGroup(self.space_group, self.space_rank,
                                  self.space)

    def image_rows(self, height: int) -> slice:
        """This rank's rows of an image of ``height`` rows (all of them
        without a ``space`` axis)."""
        if self.space == 1:
            return slice(None)
        if height % self.space:
            raise ValueError(f"the canvas height {height} is not divisible "
                             f"by the space axis ({self.space})")
        part = height // self.space
        return slice(self.space_rank * part, (self.space_rank + 1) * part)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def multi_process(self) -> bool:
        return self.group is not None

    def local_rows(self, global_size: int, accum_steps: int = 1
                   ) -> np.ndarray:
        """This rank's rows of a global batch of ``global_size``: for each
        of the ``accum_steps`` micro-batches, in micro-batch order, the
        rank's contiguous part of that micro-batch (detjax's micro-batch i
        is global rows ``[i*B/A, (i+1)*B/A)``, sharded over ``data``). The
        S ranks of a space group take the same rows, their data index's."""
        # a single-process mesh holds every row (its devices split them)
        w = self.data_size if self.multi_process else 1
        accum = max(int(accum_steps), 1)
        if global_size % (accum * w):
            raise ValueError(
                f"a global batch of {global_size} does not split into "
                f"{accum} micro-batches over {w} ranks")
        mb = global_size // accum
        part = mb // w
        d = self.data_rank
        return np.concatenate([
            np.arange(i * mb + d * part, i * mb + (d + 1) * part)
            for i in range(accum)])


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is a :class:`Mesh` this package can run; TypeError
    for another object, NotImplementedError for a ``space`` axis on a
    single-process mesh (ROADMAP Queue 1 #8)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a detjax_torch.parallel.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    if mesh.space > 1 and not mesh.multi_process:
        raise NotImplementedError(SPACE_SERVING_NOT_PORTED)
    return mesh


def _distributed_launch() -> bool:
    """Whether this process is a rank of a distributed run: a default
    process group is initialised, or torchrun's variables are set."""
    return dist.is_initialized() or all(v in os.environ
                                        for v in TORCHRUN_VARS)


def _rank_device(devices, rank: int) -> torch.device:
    """This rank's device: ``devices``' one, a bare ``cuda`` being
    ``cuda:LOCAL_RANK``."""
    device = torch.device("cuda")
    if devices is not None:
        devices = list(devices)
        if len(devices) != 1:
            raise ValueError(f"a multi-process mesh holds one device a "
                             f"process, got {len(devices)}")
        device = torch.device(devices[0])
    resolve_device(device)  # raises without CUDA: no quiet CPU mesh
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank
    count = torch.cuda.device_count()
    if index >= count:
        raise ValueError(
            f"LOCAL_RANK={local} (RANK={rank}) names cuda:{index}, but "
            f"{count} CUDA device(s) are visible: run at most {count} "
            f"process(es) a host, or pass make_mesh(devices=...)")
    return torch.device("cuda", index)


def _local_devices(devices) -> List[torch.device]:
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("make_mesh got no devices")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in out]


def make_mesh(devices: Optional[Sequence[Any]] = None,
              axis_name: str = "data", spatial: int = 1) -> Mesh:
    """The data-parallel :class:`Mesh` of this process.

    In a distributed run (an initialised default group, or torchrun's
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``) the mesh is multi-process: the group's ranks, each
    with one device, ``devices[0]`` or else ``cuda:LOCAL_RANK``; a group
    that is not initialised yet is, with NCCL for a CUDA device and gloo
    for the CPU. Otherwise it is single-process over ``devices``, by
    default every visible CUDA device. Without CUDA and without an
    explicit CPU device it raises.

    ``spatial > 1`` makes the mesh ``(data, space)``: rank r has data
    index ``r // spatial`` and space index ``r % spatial``, and every rank
    creates every data and space group (``dist.new_group``) in the same
    order. detjax's ValueError when ``spatial`` does not divide the
    devices; NotImplementedError for a single-process mesh (ROADMAP Queue
    1 #8)."""
    if _distributed_launch():
        rank = (dist.get_rank() if dist.is_initialized()
                else int(os.environ["RANK"]))
        device = _rank_device(devices, rank)
        if not dist.is_initialized():
            if device.type == "cuda":
                torch.cuda.set_device(device)
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                init_method="env://")
        mesh = Mesh((device,), dist.group.WORLD, dist.get_rank(),
                    dist.get_world_size(), axis_name)
    else:
        mesh = Mesh(tuple(_local_devices(devices)), axis_name=axis_name)
    if spatial > 1:
        if mesh.size % spatial:
            raise ValueError(
                f"spatial={spatial} does not divide {mesh.size} devices")
        if not mesh.multi_process:
            raise NotImplementedError(SPACE_SERVING_NOT_PORTED)
        w = mesh.world_size
        space_groups = [dist.new_group(list(range(d, d + spatial)))
                        for d in range(0, w, spatial)]
        data_groups = [dist.new_group(list(range(s, w, spatial)))
                       for s in range(spatial)]
        mesh = dataclasses.replace(
            mesh, space=spatial,
            space_group=space_groups[mesh.rank // spatial],
            data_group=data_groups[mesh.rank % spatial])
    return mesh


# -- replication -------------------------------------------------------------

def _to_device(tree, device: torch.device):
    """A copy of ``tree`` (a module, a tensor, or dicts, lists and tuples
    of them) on ``device``; the tree itself where it already lives
    there."""
    if isinstance(tree, torch.nn.Module):
        first = next(tree.parameters(), None)
        if first is not None and first.device == device:
            return tree
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def _broadcast_tensors(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Overwrite ``tensors`` with rank 0's, one broadcast for each dtype
    and device."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in groups.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=0, group=mesh.group)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def _state_layout(state: TrainState) -> dict:
    """The host-side part of a state that rank 0 hands to the others: the
    step, each group's rate, each parameter's optimizer counts and the
    names and shapes of its tensors."""
    opt = []
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            st = state.optimizer.state.get(p, {})
            opt.append({k: (("tensor", tuple(v.shape), str(v.dtype))
                            if isinstance(v, torch.Tensor) else v)
                        for k, v in st.items()})
    return {"step": state.step,
            "lr": [g["lr"] for g in state.optimizer.param_groups],
            "opt": opt}


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    out = list(state.model.parameters()) + list(state.model.buffers())
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            st = state.optimizer.state.get(p, {})
            out += [st[k] for k in sorted(st)
                    if isinstance(st[k], torch.Tensor)]
    if state.ema is not None:
        out += [state.ema[k] for k in sorted(state.ema)]
    return out


def parallel_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Make every rank's state rank 0's, in place: the parameters and
    buffers, the optimizer's moments and counts, the EMA shadow, the step
    and the learning rate (detjax replicates the state, ``P()``). A no-op
    in one process."""
    check_mesh(mesh)
    if not mesh.multi_process or mesh.world_size == 1:
        return state
    layout = [_state_layout(state)]
    dist.broadcast_object_list(layout, src=0, group=mesh.group)
    layout = layout[0]
    state.step = layout["step"]
    for group, lr in zip(state.optimizer.param_groups, layout["lr"]):
        group["lr"] = lr
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p, want in zip(params, layout["opt"]):
        st = state.optimizer.state[p]
        for k, v in want.items():
            if isinstance(v, tuple) and v[:1] == ("tensor",):
                if k not in st or tuple(st[k].shape) != v[1]:
                    st[k] = torch.zeros(v[1], dtype=getattr(
                        torch, v[2].split(".")[-1]), device=p.device)
            else:
                st[k] = v
        for k in [k for k in st if k not in want]:
            del st[k]
    _broadcast_tensors(_state_tensors(state), mesh)
    return state


def replicate(tree, mesh: Mesh) -> list:
    """This process's replicas of ``tree`` (a module, a tensor, or dicts,
    lists and tuples of them), one on each of the mesh's devices (``tree``
    itself where it already lives there), each holding rank 0's values:
    in a multi-process mesh the one replica is overwritten with rank 0's
    tensors, in place. A train state is :func:`parallel_train_state`'s."""
    check_mesh(mesh)
    replicas = [_to_device(tree, d) for d in mesh.devices]
    if mesh.multi_process and mesh.world_size > 1:
        tensors: List[torch.Tensor] = []

        def collect(t):
            if isinstance(t, torch.nn.Module):
                tensors.extend(list(t.parameters()) + list(t.buffers()))
            elif isinstance(t, torch.Tensor):
                tensors.append(t)
            elif isinstance(t, dict):
                for k in sorted(t):
                    collect(t[k])
            elif isinstance(t, (list, tuple)):
                for v in t:
                    collect(v)

        collect(replicas[0])
        _broadcast_tensors(tensors, mesh)
    return replicas


def split_over(dev: torch.device, runs: Sequence[Callable]) -> Callable:
    """``run(images)`` for a single-process mesh: split a batch into
    ``len(runs)`` contiguous slices, dispatch slice i through ``runs[i]``
    (device i's replica) and gather the ``Detections`` on ``dev`` in
    order."""
    def run(images):
        part = len(images) // len(runs)
        dets = [r(images[i * part:(i + 1) * part])
                for i, r in enumerate(runs)]
        return Detections(*(torch.cat([t.to(dev) for t in field])
                            for field in zip(*dets)))

    return run


# -- batches -----------------------------------------------------------------

def cut_image_rows(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """``batch`` with ``images`` [B, H, W, 3] cut to this rank's rows on a
    ``space`` axis (detjax's ``P('data', 'space')``), the rest as it is."""
    if mesh.space == 1 or "images" not in batch:
        return batch
    images = batch["images"]
    return dict(batch, images=images[:, mesh.image_rows(images.shape[1])])


def shard_batch(batch: Dict[str, Any], mesh: Mesh,
                accum_steps: int = 1) -> Dict[str, Any]:
    """This rank's rows of a **global** batch, where they lie (host or
    device; the step copies them to the rank's device): for each of
    ``accum_steps`` micro-batches, the rank's part of that micro-batch,
    in micro-batch order (:meth:`Mesh.local_rows`); on a ``space`` axis
    its data index's images cut to its own image rows, the GT whole."""
    rows = mesh.local_rows(len(next(iter(batch.values()))), accum_steps)
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v[torch.as_tensor(rows, device=v.device)]
        else:
            out[k] = np.asarray(v)[rows]
    return cut_image_rows(out, mesh)


def global_batch_from_local(batch: Dict[str, Any], mesh: Mesh
                            ) -> Dict[str, torch.Tensor]:
    """A rank's **local** batch (e.g. from ``make_train_iterator(
    per_host=True, mesh=mesh)``: its data index's images), on the rank's
    device, the images cut to its own rows on a ``space`` axis: under
    torch.distributed each rank holds only its shard, which is what
    detjax's ``make_array_from_process_local_data`` assembles."""
    _one_device(mesh)
    return {k: torch.as_tensor(v).to(mesh.device, non_blocking=True)
            for k, v in cut_image_rows(batch, mesh).items()}


def _one_device(mesh: Mesh) -> None:
    check_mesh(mesh)
    if len(mesh.devices) != 1:
        raise ValueError(
            f"training takes one device a process; this single-process "
            f"mesh has {len(mesh.devices)} (it serves and evaluates): run "
            f"one process a device under torchrun")


# -- the step ----------------------------------------------------------------

def make_parallel_train_step(cfg: Config, mesh: Mesh):
    """The data-parallel train step: ``run(state, batch)`` with detjax's
    shape. ``batch`` is this rank's share of the global batch
    (:func:`shard_batch`, :func:`global_batch_from_local`); every rank's
    ``state`` must already be rank 0's (:func:`parallel_train_state`).
    ``run.warmup(state, batch)`` builds the step's CUDA kernels without
    stepping, so that no rank reaches its first collective while another
    still compiles."""
    _one_device(mesh)

    def run(state: TrainState, batch, match_backend: str = "auto",
            record=None):
        return train_step(state, batch, match_backend, record, mesh=mesh)

    def warmup(state: TrainState, batch) -> None:
        if mesh.device.type == "cuda":
            from detjax_torch.kernels import matching

            matching._lib()

    run.warmup = warmup
    return run
