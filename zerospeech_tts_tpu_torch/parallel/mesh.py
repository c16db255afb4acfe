"""The ``data`` and ``model`` axes of the PyTorch port's mesh (counterpart
of ``zerospeech_tts_tpu/parallel/mesh.py`` and of the JAX CLI's
``_mesh_from_arg``).

``--mesh data=D,model=M`` lays D*M processes out as JAX's make_mesh lays
devices out (``devices[:n].reshape(data, model)``): rank r sits at (d, m)
= (r // M, r % M) (``Mesh``). The batch is split over ``data`` and
replicated over ``model``: the M ranks of data row d hold its d-th
contiguous block of rows (``batch_slice``) and step on the same rows.

Tensor parallelism over ``model`` follows JAX's rule (``spec_for``): a
parameter with ndim >= 2, at least ``min_size`` elements and a last axis
(in JAX's layout) that divides by M is kept as M contiguous blocks of that
axis, rank (d, m) holding block m of the parameter and of its two Adam
moments; every other parameter is whole on every rank. JAX's last axis is
a kernel's output axis: torch dim 0 of a Conv/Linear weight, and the last
dim of the GRU ``wh`` and of the speaker embedding, which keep JAX's layout
(``params.flax_last_axis``). The block of ``wh``'s 3H crosses gate
boundaries, as JAX's does. ``shard_state`` places a ``TrainState`` so
(``ModelShards``): between steps a rank keeps its blocks and the whole
leaves; a step gathers the whole weights of each module it reads over the
model group and frees them once the module is updated or the step ends.

Conversion replicates the parameters and splits the rows over ``data``:
one card a data block (``conversion_devices``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from zerospeech_tts_tpu_torch.params import flax_last_axis
from zerospeech_tts_tpu_torch.parallel.distributed import all_gather_slices

MIN_SIZE = 1 << 14  # JAX's min_size: smaller leaves stay whole
MOMENTS = ("exp_avg", "exp_avg_sq")  # Adam's per-parameter tensors that follow the parameter's layout


@dataclass(frozen=True)
class Mesh:
    """Rank ``rank``'s place on a (data, model) mesh of data * model
    processes."""

    data: int = 1
    model: int = 1
    rank: int = 0

    @property
    def d(self) -> int:
        return self.rank // self.model

    @property
    def m(self) -> int:
        return self.rank % self.model


def parse_mesh(spec: str | None, n_devices: int | None = None) -> tuple[int, int]:
    """(data, model) of ``"data=D[,model=M]"`` (None or "" -> (1, 1)). As
    JAX's make_mesh: ``data`` left out means n_devices // model, and a mesh
    of more than ``n_devices`` raises ValueError("... needs N devices, have
    K")."""
    if not spec:
        return 1, 1
    axes = {}
    for part in spec.split(","):
        k, sep, v = part.partition("=")
        if not sep or k.strip() not in ("data", "model"):
            raise ValueError(f"--mesh {spec!r}: want data=D[,model=M]")
        axes[k.strip()] = int(v)
    model = axes.get("model", 1)
    data = axes.get("data")
    if data is None:
        if n_devices is None:
            raise ValueError(f"--mesh {spec!r}: name the data axis (data=D)")
        data = n_devices // model
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec!r}: axis sizes must be positive")
    if n_devices is not None and data * model > n_devices:
        raise ValueError(f"mesh data={data} x model={model} needs {data * model} devices, have {n_devices}")
    return data, model


def batch_slice(rank: int, world: int, n: int) -> slice:
    """The rows of an ``n``-row batch that data rank ``rank`` of ``world``
    owns: the rank-th of ``world`` equal contiguous blocks (JAX: ``n %
    data`` must be 0 to shard a batch over the axis)."""
    if n % world:
        raise ValueError(f"batch of {n} rows does not divide over {world} ranks")
    b = n // world
    return slice(rank * b, (rank + 1) * b)


def conversion_devices(device: str | torch.device, data: int, model: int = 1) -> list[torch.device]:
    """The devices one conversion process splits its batches over: for
    ``cuda``, card d * model for each data block d (the parameters are
    replicated over ``model``, so each block is converted once), raising
    when fewer than data * model cards are visible; for the CPU, the CPU
    ``data`` times (the split itself, on one device)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * data
    n = torch.cuda.device_count()
    if data * model > n:
        raise ValueError(f"mesh data={data} x model={model} needs {data * model} devices, "
                         f"have {n} CUDA device(s)")
    return [torch.device("cuda", d * model) for d in range(data)]


# ------------------------------------------------------ tensor parallelism


def spec_for(key: str, shape, model: int, min_size: int = MIN_SIZE) -> int | None:
    """The torch axis of state-dict entry ``key`` (``shape``) that JAX's
    ``_spec_for`` shards over a ``model`` axis of that size, or None (the
    leaf stays whole): ndim >= 2, at least ``min_size`` elements, and a
    last JAX axis that divides by ``model``."""
    if model <= 1 or len(shape) < 2 or math.prod(shape) < min_size:
        return None
    axis = flax_last_axis(key, len(shape))
    return axis if shape[axis] % model == 0 else None


def param_shardings(modules: dict, model: int, min_size: int = MIN_SIZE) -> dict:
    """{module name: {parameter name: axis or None}} for named modules
    (JAX ``param_shardings``)."""
    return {n: {k: spec_for(k, p.shape, model, min_size) for k, p in mod.named_parameters()}
            for n, mod in modules.items()}


def shard(t: torch.Tensor, axis: int | None, mesh: Mesh) -> torch.Tensor:
    """Rank ``mesh.m``'s block of ``t`` along ``axis`` (a view; ``t`` itself
    when ``axis`` is None)."""
    if axis is None:
        return t
    b = t.shape[axis] // mesh.model
    return t.narrow(axis, mesh.m * b, b)


def state_tree(state) -> dict:
    """A whole (unplaced) TrainState's parameters and Adam moments as
    named tensors, {"params" | moment: {module: {name: tensor}}}: what
    ``device0_bytes`` counts of a state."""
    tree: dict = {"params": {n: dict(mod.named_parameters()) for n, mod in state.modules.items()}}
    for key in MOMENTS:
        tree[key] = {n: {k: state.opts[n].state[p][key] for k, p in mod.named_parameters() if p in state.opts[n].state}
                     for n, mod in state.modules.items()}
    return tree


def device0_bytes(tree: dict, mesh: Mesh, min_size: int = MIN_SIZE) -> tuple[int, int]:
    """(bytes rank 0 holds, total logical bytes) of nested dicts of named
    tensors (state dicts, ``state_tree``) placed by the rule on ``mesh``:
    the TP memory count (sharded < total, replicated == total). Every rank
    holds as many bytes as rank 0 (the blocks are equal)."""
    dev_b = total_b = 0
    for key, v in tree.items():
        if isinstance(v, dict):
            d, t = device0_bytes(v, mesh, min_size)
        else:
            t = v.numel() * v.element_size()
            d = t if spec_for(key, v.shape, mesh.model, min_size) is None else t // mesh.model
        dev_b, total_b = dev_b + d, total_b + t
    return dev_b, total_b


class ModelShards:
    """The tensor-parallel half of a placed ``TrainState``: per module, the
    tensors its Adam steps (``masters``: the rank's block of each sharded
    parameter, the parameter itself for a whole one), each parameter's axis
    and whole shape, and the modules whose whole weights the running step
    has gathered. Between steps a sharded parameter of the module holds no
    elements."""

    def __init__(self, state, mesh: Mesh, group, min_size: int = MIN_SIZE):
        self.mesh, self.group = mesh, group
        self.axes = {n: list(a.values()) for n, a in param_shardings(state.modules, mesh.model, min_size).items()}
        self.shapes = {n: [p.shape for p in mod.parameters()] for n, mod in state.modules.items()}
        self.masters, self.whole = {}, set()
        for n, mod in state.modules.items():
            opt, saved = state.opts[n], state.opts[n].state_dict()
            self.masters[n] = [p if ax is None else torch.nn.Parameter(shard(p.detach(), ax, mesh).clone())
                               for p, ax in zip(mod.parameters(), self.axes[n])]
            state.opts[n] = type(opt)(self.masters[n], **opt.defaults)
            state.opts[n].load_state_dict(self._sliced(n, saved))
            self.release(state, n)

    def _sliced(self, n: str, opt_sd: dict) -> dict:
        """A whole optimizer state dict of module ``n`` with this rank's
        block of each sharded parameter's moments (the step counts kept)."""
        return dict(opt_sd, state={i: {k: shard(v, self.axes[n][i], self.mesh).clone()
                                       if k in MOMENTS and self.axes[n][i] is not None else v
                                       for k, v in st.items()} for i, st in opt_sd["state"].items()})

    def _sharded(self, state, n: str):
        return [(p, m, ax) for p, m, ax in zip(state.modules[n].parameters(), self.masters[n], self.axes[n])
                if ax is not None]

    def gather(self, state, n: str) -> None:
        """Module ``n``'s whole weights, gathered over the model group,
        unless the running step gathered them already."""
        if n not in self.whole:
            for p, master, ax in self._sharded(state, n):
                p.data = all_gather_slices(master.detach(), ax, self.group)
            self.whole.add(n)

    def release(self, state, n: str) -> None:
        """Free module ``n``'s gathered weights and its masters' gradients."""
        for p, _, _ in self._sharded(state, n):
            p.data = p.data.new_empty(0)
        for master in self.masters[n]:
            master.grad = None
        self.whole.discard(n)

    def set_grads(self, n: str, grads, scale) -> None:
        """Each master's ``.grad``: its block of the whole (clipped) gradient."""
        for master, g, ax in zip(self.masters[n], grads, self.axes[n]):
            master.grad = shard(g, ax, self.mesh) * scale

    def whole_state_dicts(self, state) -> tuple[dict, dict]:
        """({module: state dict}, {module: Adam state dict}) with every
        parameter and moment whole, gathered over the model group (a
        collective: every rank of the group calls it)."""
        modules, opts = {}, {}
        for n, mod in state.modules.items():
            modules[n] = mod.state_dict()
            for (k, _), master, ax in zip(mod.named_parameters(), self.masters[n], self.axes[n]):
                if ax is not None:
                    modules[n][k] = all_gather_slices(master.detach(), ax, self.group)
            sd = state.opts[n].state_dict()
            opts[n] = dict(sd, state={i: {k: all_gather_slices(v, self.axes[n][i], self.group)
                                          if k in MOMENTS and self.axes[n][i] is not None else v
                                          for k, v in st.items()} for i, st in sd["state"].items()})
        return modules, opts

    def load(self, state, modules: dict, opts: dict) -> None:
        """Keep this rank's blocks of whole state dicts (a checkpoint's),
        strictly: another architecture raises, as ``load_state_dict``."""
        for n, mod in state.modules.items():
            names = [k for k, _ in mod.named_parameters()]
            want = dict(zip(names, map(tuple, self.shapes[n])))
            got = {k: tuple(v.shape) for k, v in modules[n].items()}
            if got != want:
                raise RuntimeError(f"checkpoint module {n}: entries {got} do not match the state's {want}")
            with torch.no_grad():
                for k, master, ax in zip(names, self.masters[n], self.axes[n]):
                    master.copy_(shard(modules[n][k], ax, self.mesh))
            state.opts[n].load_state_dict(self._sliced(n, opts[n]))
            self.release(state, n)


def shard_state(state, mesh: Mesh, group, min_size: int = MIN_SIZE):
    """Place a whole TrainState by the rule (``ModelShards``): its modules'
    sharded parameters and their Adam moments become this rank's blocks;
    ``group`` is the rank's model group (distributed.mesh_groups)."""
    state.shards = ModelShards(state, mesh, group, min_size)
    return state


def replicate_state(state):
    """Make every parameter and moment of a TrainState whole again (the
    pure data-parallel layout); a state that is not sharded is returned as
    it is. A collective over the model group for a sharded one."""
    if state.shards is None:
        return state
    shards, (modules, opts) = state.shards, state.whole_state_dicts()
    state.shards = None
    for n, mod in state.modules.items():
        for (k, p), ax in zip(mod.named_parameters(), shards.axes[n]):
            if ax is not None:
                p.data = modules[n][k]
        opt = state.opts[n]
        state.opts[n] = type(opt)(mod.parameters(), **opt.defaults)
        state.opts[n].load_state_dict(opts[n])
    return state


def place_state(state, mesh: Mesh, group, min_size: int = MIN_SIZE):
    """The CLI's placement of a TrainState (JAX ``place_state``): sharded
    over ``model`` when the mesh has a model axis above 1, whole
    otherwise."""
    if mesh.model > 1:
        return shard_state(state, mesh, group, min_size)
    return replicate_state(state)
