"""Sharding rules mapping model parameters, activations and caches onto
the production mesh (data, model[, pod]); the port of the JAX package's
``distributed/sharding.py``, every decision kept.

Strategy:
  * Megatron tensor parallelism on the ``model`` axis: attention heads,
    FFN hidden dim, MoE expert hidden dim, vocab, Mamba inner dim, RG-LRU
    recurrent dim.  Archs whose head count does not divide the axis
    (gemma-2b 8H, recurrentgemma 10H) replicate attention and shard FFN.
  * ``train`` mode additionally shards a second large dim per tensor on
    the fsdp axes (ZeRO-3 storage; gathered at use) and stores
    activations sequence-parallel between blocks.
  * ``serve`` mode: tensor parallel only for ≤8 GiB/chip models, 2-D
    (model × data) weight sharding for the big ones (dbrx, mixtral, qwen).
  * MoE experts: tensor-parallel over d_ff by default; ``expert_parallel``
    shards the expert dim over ``model`` instead (all-to-all dispatch).

A spec is a per-dim tuple of mesh axis names (or ``None``, or a tuple of
names for a dim split over several axes), as JAX's ``PartitionSpec``
holds them.  The rules decide from the mesh's axis names and sizes alone
(``launch.mesh.mesh_axes``), so an ``AbstractMesh`` gives the same specs
as a ``DeviceMesh`` of that shape.  ``placements(spec)`` turns a spec into
DTensor placements, one per mesh dim; a dim over ``("pod", "data")`` is
sharded pod-major, as JAX lays it out.  The port's model holds one block
per layer where JAX stacks the pattern into scanned units: a per-layer
leaf gets the spec JAX gives the unit-stacked leaf without its leading
``None``.

``constrain(x, name)`` is the hook the models call: on a DTensor it
redistributes to the named layout; anything else passes through, and
where JAX returns ``x`` to let GSPMD choose, so does the port.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.launch.mesh import mesh_axes

MODEL_AXIS = "model"


def _axis_size(axes, name):
    if isinstance(name, tuple):
        return math.prod(_axis_size(axes, n) for n in name)
    return axes[name]


def _div(n, axes, axis):
    return axis is not None and n % _axis_size(axes, axis) == 0


class ShardingRules:
    """Resolves specs for a (cfg, mesh, mode) triple."""

    def __init__(self, cfg, mesh, mode="train", fsdp_axes=None,
                 expert_parallel=False, seq_parallel=True):
        if mode not in ("train", "serve"):
            raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.axes = mesh_axes(mesh)
        self.axis_names = tuple(self.axes)
        self.mode = mode
        self.expert_parallel = expert_parallel
        self.seq_parallel = seq_parallel
        if fsdp_axes is None:
            fsdp_axes = ("pod", "data") if "pod" in self.axes else ("data",)
        self.fsdp = tuple(a for a in fsdp_axes if a in self.axes)
        self.fsdp_axis = self.fsdp if len(self.fsdp) > 1 else (
            self.fsdp[0] if self.fsdp else None)
        self.data_axis = ("pod", "data") if "pod" in self.axes else "data"

    # -------------------------------------------------------------- #
    def _fsdp_dim(self, shape, spec, skip=()):
        """Pick the largest still-unsharded dim divisible by the fsdp axes."""
        if self.mode != "train" or self.fsdp_axis is None:
            return spec
        cands = [(d, i) for i, d in enumerate(shape)
                 if spec[i] is None and i not in skip
                 and _div(d, self.axes, self.fsdp_axis)]
        if not cands:
            return spec
        _, i = max(cands)
        out = list(spec)
        out[i] = self.fsdp_axis
        return tuple(out)

    def param_spec(self, path: str, shape) -> tuple:
        """path: '/'- or '.'-joined key names; only the last one is read.
        ``shape`` is one layer's (JAX's unit-stacked leaf without its
        leading axis)."""
        cfg, axes = self.cfg, self.axes
        name = path.replace(".", "/").split("/")[-1]
        spec = [None] * len(shape)

        def set_dim(i, axis):
            if _div(shape[i], axes, axis):
                spec[i] = axis
                return True
            return False

        heads_ok = _div(cfg.n_heads, axes, MODEL_AXIS) if cfg.n_heads \
            else False
        kv_ok = _div(cfg.n_kv_heads, axes, MODEL_AXIS) if cfg.n_kv_heads \
            else False

        if name in ("embed", "lm_head"):
            # vocab dim = the dim matching padded_vocab
            for i, d in enumerate(shape):
                if d == cfg.padded_vocab:
                    set_dim(i, MODEL_AXIS)
                    break
        elif name == "wq":
            if heads_ok:
                set_dim(len(shape) - 2, MODEL_AXIS)
            else:
                set_dim(len(shape) - 3, MODEL_AXIS)  # contraction d_model
        elif name in ("wk", "wv"):
            if kv_ok:
                set_dim(len(shape) - 2, MODEL_AXIS)
        elif name == "bq":
            if heads_ok:
                set_dim(len(shape) - 2, MODEL_AXIS)
        elif name in ("bk", "bv"):
            if kv_ok:
                set_dim(len(shape) - 2, MODEL_AXIS)
        elif name == "wo":
            if heads_ok:
                set_dim(len(shape) - 3, MODEL_AXIS)
            else:
                set_dim(len(shape) - 1, MODEL_AXIS)  # output d_model
        elif name in ("w_in", "w_gate"):
            is_moe = len(shape) >= 3 and shape[-3] == cfg.n_experts
            # expert-parallel only when E divides the axis (dbrx 16e);
            # otherwise tensor-parallel d_ff (mixtral 8e < 16)
            if not (is_moe and self.expert_parallel
                    and set_dim(len(shape) - 3, MODEL_AXIS)):
                set_dim(len(shape) - 1, MODEL_AXIS)
        elif name == "w_out":
            is_moe = len(shape) >= 3 and shape[-3] == cfg.n_experts
            if not (is_moe and self.expert_parallel
                    and set_dim(len(shape) - 3, MODEL_AXIS)):
                set_dim(len(shape) - 2, MODEL_AXIS)
        elif name == "in_proj":   # mamba2: keep mixed projection unsharded
            set_dim(len(shape) - 2, MODEL_AXIS)   # contraction d_model
        elif name == "out_proj":
            set_dim(len(shape) - 2, MODEL_AXIS)   # d_inner / d_rnn contraction
        elif name in ("proj_rec", "proj_gate"):
            set_dim(len(shape) - 1, MODEL_AXIS)   # d_rnn column-parallel
        elif name in ("w_a", "w_x"):
            set_dim(len(shape) - 2, MODEL_AXIS)   # dr contraction
        # norms / scalars / conv weights / router: replicated

        return self._fsdp_dim(shape, tuple(spec))

    def params_tree(self, params) -> dict:
        """{parameter name: spec} of the port's ``Params`` (or of a
        {name: tensor} mapping)."""
        items = (params.named_parameters() if hasattr(params,
                                                      "named_parameters")
                 else params.items())
        return {k: self.param_spec(k, tuple(p.shape)) for k, p in items}

    # -------------------------------------------------------------- #
    # activations / batch / caches
    # -------------------------------------------------------------- #
    def activation_spec(self, shape, name):
        """The spec ``constrain`` lays a ``name`` activation of ``shape``
        out on, or None where JAX leaves it to GSPMD."""
        axes = self.axes
        ndim = len(shape)

        def batch_ax():
            return self.data_axis if _div(shape[0], axes, self.data_axis) \
                else None

        if name == "heads":
            # (B, S|T, H, hd): keep expanded GQA kv / qkv head-sharded.
            # Indivisible head counts (musicgen 24H) are left alone, as
            # JAX leaves them to GSPMD (constraining them hurt there)
            if _div(shape[2], axes, MODEL_AXIS):
                return (batch_ax(), None, MODEL_AXIS, None)
            return None
        if name == "heads_decode":
            # decode path: match the KV-cache layout (head_dim -> model)
            hd = MODEL_AXIS if _div(shape[3], axes, MODEL_AXIS) else None
            return (batch_ax(), None, None, hd)
        if name == "attn_scores":
            # (B, H, S, T): when H doesn't divide the model axis, shard the
            # key axis instead (context parallelism)
            if _div(shape[1], axes, MODEL_AXIS):
                return None  # heads already carry the model axis
            t_ax = MODEL_AXIS if _div(shape[3], axes, MODEL_AXIS) else None
            return (batch_ax(), None, None, t_ax)
        if name == "moe_buf":
            # (G, E, C, d/f) capacity buffer at dispatch: groups -> data,
            # features -> model, E unsharded (the scatter stays local)
            f_ax = MODEL_AXIS if _div(shape[3], axes, MODEL_AXIS) else None
            return (batch_ax(), None, None, f_ax)
        if name == "moe_buf_expert":
            # compute layout: moe_buf -> moe_buf_expert IS the
            # expert-parallel all-to-all; the dispatch layout when E does
            # not divide the axis (mixtral 8e: tensor-parallel experts)
            if _div(shape[1], axes, MODEL_AXIS) and self.expert_parallel:
                return (batch_ax(), MODEL_AXIS, None, None)
            f_ax = MODEL_AXIS if _div(shape[3], axes, MODEL_AXIS) else None
            return (batch_ax(), None, None, f_ax)
        if name == "moe_groups":
            # (G, T_local, d) grouped token tensors: groups -> data
            d = MODEL_AXIS if _div(shape[2], axes, MODEL_AXIS) else None
            return (batch_ax(), None, d)
        if name == "resid":
            seq = MODEL_AXIS if (self.seq_parallel and self.mode == "train"
                                 and shape[1] % _axis_size(axes, MODEL_AXIS)
                                 == 0) else None
            return (batch_ax(), seq, None)
        if name == "logits":
            vocab = MODEL_AXIS if _div(shape[-1], axes, MODEL_AXIS) else None
            return tuple([batch_ax()] + [None] * (ndim - 2) + [vocab])
        return None

    def constrain(self, x, name):
        """Sharding-constraint hook handed to the model."""
        if not isinstance(x, DTensor):
            return x
        spec = self.activation_spec(tuple(x.shape), name)
        if spec is None:
            return x
        return x.redistribute(x.device_mesh, self.placements(spec))

    def batch_spec(self, shape) -> tuple:
        batch = self.data_axis if _div(shape[0], self.axes, self.data_axis) \
            else None
        return tuple([batch] + [None] * (len(shape) - 1))

    def cache_spec(self, path_keys, shape) -> tuple:
        """KV / state caches: batch->data when divisible; long seq dims and
        model-parallel feature dims -> model."""
        axes = self.axes
        name = path_keys[-1]
        batch = self.data_axis if _div(shape[0], axes, self.data_axis) \
            else None
        if name in ("k", "v"):
            # prefer head_dim -> model (a seq-sharded ring buffer makes
            # the per-step update reshard the whole cache); unbatched
            # long-context caches additionally spread seq over data
            hd_ok = _div(shape[3], axes, MODEL_AXIS)
            seq = None
            if batch is None and _div(shape[1], axes, self.data_axis):
                seq = self.data_axis
            if hd_ok:
                return (batch, seq, None, MODEL_AXIS)
            seq_m = MODEL_AXIS if seq is None and _div(
                shape[1], axes, MODEL_AXIS) else seq
            return (batch, seq_m, None, None)
        if name == "pos":
            return (None,) * len(shape)
        if name == "state":   # ssd (B,H,P,N)
            h = MODEL_AXIS if _div(shape[1], axes, MODEL_AXIS) else None
            return (batch, h, None, None)
        if name == "h":       # rglru (B,dr)
            dr = MODEL_AXIS if _div(shape[1], axes, MODEL_AXIS) else None
            return (batch, dr)
        if name == "conv":    # (B, w-1, dc)
            dc = MODEL_AXIS if _div(shape[-1], axes, MODEL_AXIS) else None
            return (batch, None, dc)
        return tuple([batch] + [None] * (len(shape) - 1))

    def caches_tree(self, caches):
        """Per-layer specs of ``transformer.init_caches``' list of dicts."""
        return [{k: self.cache_spec((k,), tuple(x.shape))
                 for k, x in cache.items()} for cache in caches]

    # -------------------------------------------------------------- #
    # DTensor layouts
    # -------------------------------------------------------------- #
    def placements(self, spec) -> tuple:
        """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)``
        on each mesh axis that tensor dim ``d`` names, ``Replicate()``
        elsewhere.  A dim over several axes is split in the mesh's axis
        order (pod-major for ``("pod", "data")``), which is the only order
        the rules use."""
        where = {}
        for d, ax in enumerate(spec):
            names = ax if isinstance(ax, tuple) else (ax,)
            order = [self.axis_names.index(a) for a in names if a is not None]
            if order != sorted(order):
                raise ValueError(f"{spec}: dim {d}'s axes {names} are not "
                                 f"in the mesh's order {self.axis_names}")
            for a in names:
                if a is not None:
                    where[a] = d
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in self.axis_names)

    def place(self, x, spec):
        """``x`` as a DTensor on ``self.mesh`` laid out by ``spec``, cut
        from this rank's own copy of the whole tensor (every rank holds
        the same ``x``: made from one seed), with no communication.  The
        shard owns its memory (a view would keep all of ``x`` alive)."""
        d = distribute_tensor(x, self.mesh, self.placements(spec),
                              src_data_rank=None)
        local = d.to_local()
        if local.untyped_storage().nbytes() > local.numel() \
                * local.element_size():
            d = DTensor.from_local(local.clone(), self.mesh, d.placements)
        return d

    def compute_spec(self, spec) -> tuple:
        """The layout a weight stored by ``spec`` is used in: the fsdp
        axes gathered (ZeRO-3), the model axis kept."""
        return tuple(None if ax == self.fsdp_axis else ax for ax in spec)

    @torch.no_grad()
    def distribute(self, params, serving=False):
        """Replace every parameter of ``params`` (a ``Params`` module) by
        a DTensor laid out by ``params_tree``, in place; keeps each
        parameter's ``requires_grad``.  Returns ``params``.

        Weights the model reads as attributes are gathered to their
        ``compute_spec`` at use (the backward reduce-scatters a gradient
        to the stored layout): every weight in training, as ZeRO-3
        storage is used; in ``serving`` only those the model axis does
        not shard (norms, routers, the kv projections of head counts the
        axis does not divide — small), and DTensor moves the smaller
        operand of every other product (a decode step's activations,
        not 2-D sharded weights).  Left to itself, DTensor's propagation
        chunks a model-replicated operand of a product and then fails to
        unflatten the result (GQA's kv heads on a wider model axis)."""
        specs = self.params_tree(params)
        for name, p in list(params.named_parameters()):
            owner, leaf = _owner(params, name)
            owner.register_parameter(leaf, torch.nn.Parameter(
                self.place(p.data, specs[name]),
                requires_grad=p.requires_grad))
            if not serving or MODEL_AXIS not in specs[name]:
                use = self.placements(self.compute_spec(specs[name]))
                _gather_at_use(owner, leaf, lambda w, use=use:
                               w.redistribute(w.device_mesh, use))
        return params

    @torch.no_grad()
    def distribute_state(self, state):
        """A train state ``{"params", "opt"}`` placed in place: the
        parameters by ``distribute``, the moments ``m`` and ``v`` each as
        its parameter (JAX's ZeRO layout); the step stays a plain 0-d
        tensor, replicated under ``implicit_replication``."""
        from repro_torch.training import optim
        specs = self.params_tree(state["params"])
        self.distribute(state["params"])
        opt = state["opt"]
        moments = [{k: self.place(x, specs[k]) for k, x in d.items()}
                   for d in (opt.m, opt.v)]
        state["opt"] = optim.OptState(opt.step, *moments)
        return state


class _GatheredAtUse:
    """Mixed into the class of a distributed model's ``Params`` (only
    there): a weight read as an attribute goes through its at-use hook
    (the ZeRO-3 gather of a weight stored sharded on the fsdp axes);
    ``named_parameters`` still yields the stored tensors."""

    def __getattr__(self, name):
        value = super().__getattr__(name)
        hook = self.__dict__["at_use"].get(name)
        return value if hook is None else hook(value)


_AT_USE_CLASSES = {}


def _gather_at_use(owner, leaf, hook):
    """Route reads of ``owner.<leaf>`` through ``hook``: ``owner`` takes a
    subclass of its class with ``_GatheredAtUse`` mixed in."""
    owner.__dict__.setdefault("at_use", {})[leaf] = hook
    cls = type(owner)
    if not issubclass(cls, _GatheredAtUse):
        if cls not in _AT_USE_CLASSES:
            _AT_USE_CLASSES[cls] = type(cls.__name__, (_GatheredAtUse, cls),
                                        {})
        owner.__class__ = _AT_USE_CLASSES[cls]


def _owner(module, name):
    *path, leaf = name.split(".")
    for p in path:
        module = getattr(module, p)
    return module, leaf


def full_tensor(x):
    """The whole tensor of a DTensor (gathered), else ``x``."""
    return x.full_tensor() if isinstance(x, DTensor) else x
