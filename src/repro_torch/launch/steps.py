"""Step factories for every (arch x input-shape) combination (the port of
``src/repro/launch/steps.py``).

For each shape kind ``build_step`` returns the step, its arguments and
their placements:

* train_4k     -> the distributed AFL round (``core/distributed.py``, the
                  paper's technique) over a ``ClientMesh``,
* prefill_32k  -> prompt pass returning (last logits, KV/recurrent cache),
* decode_32k   -> one-token decode against a seq_len cache,
* long_500k    -> one-token decode, sub-quadratic path (ring-buffer sliding
                  window for full-attention archs; native recurrent state for
                  SSM/hybrid).  Skipped for whisper (``supported``).

``args`` are meta tensors (shapes and dtypes, no memory) of one rank's
part, as the reference's are ``ShapeDtypeStruct``s; the Python ints the
port keeps on the host (the train state's ``rnd``, a transformer cache's
``length``) stand where the reference holds an int32 scalar.
``materialize`` turns ``args`` into real tensors on a device.
``in_shardings`` holds the rules' specs (``sharding/rules.py``): for
train, ``RULES_TRAIN`` with the client axis on data (``variant=
"dp_client"``: ``RULES_TRAIN_DP``) on the state (``core/distributed.py::
state_shardings``) and the batch; for serve, ``RULES_SERVE`` on the
parameters, the batch and the cache.  Over a (data, model) mesh each rank
holds the blocks its coordinates select: a train step's state and a serve
step's parameters, inputs and cache (every family's tensor-parallel
layers compute on them).
A serve step runs on any (data, model) mesh, as ``RULES_SERVE`` places
it: over ``data`` each rank runs its rows of the batch (the MoE dispatch
groups that span ranks exchange their expert counts), or, where the batch
does not divide (long_500k at batch 1), the whole batch over its block of
the cache's slots, the attentions merged over the ranks; a prefill
whose batch does not divide runs whole on every rank, which keeps its
block of the cache's slots.  Over ``model`` a decode cache whose kv heads
do not divide holds the rank's block of the slots where the rules cut its
``head_dim`` (``sharding/rules.py::model_slots``), nested in its data
block.  ``local_args`` cuts a rank's arguments out of whole ones.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import FLConfig, InputShape, ModelConfig
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import (ClientMesh, mesh_num_clients,
                                     require_model_axis)
from repro_torch.models.registry import (Model, build_model, data_cache,
                                         input_specs, local_cache,
                                         local_params)
from repro_torch.sharding import rules as R
from repro_torch.sharding.rules import torch_dtype
from repro_torch.utils.tree import tree_flatten, tree_unflatten

SLIDING_WINDOW = 8192  # ring-buffer size for long-context decode


def resolve_cfg(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-specific config tweaks (sliding-window for long_500k; remat on
    for training, as the reference, whose saved activations would not fit
    otherwise)."""
    if (
        shape.name == "long_500k"
        and cfg.family in ("dense", "moe", "vlm")
        and cfg.sliding_window == 0
    ):
        cfg = cfg.replace(sliding_window=SLIDING_WINDOW)
    if shape.kind == "train" and cfg.remat == "none":
        cfg = cfg.replace(remat="full")
    return cfg


def supported(cfg: ModelConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def cache_max_seq(cfg: ModelConfig, shape: InputShape) -> int:
    if cfg.family in ("ssm",):
        return 0
    if shape.name == "long_500k":
        return SLIDING_WINDOW
    return shape.seq_len


WARN_VARIANTS = ("default", "dp_client")

# dp_client: replicate the parameters, keep clients on (pod, data) and
# data-parallel each client's sequences over its `model` axis, against
# "default"'s tensor-parallel parameters over `model` (the reference's
# rules): no per-layer collective, one gradient all-reduce over `model`
RULES_TRAIN_DP = {
    "client": [("pod", "data"), ("data",)],
    "batch": [("pod", "data", "model"), ("data", "model")],
    **{k: [None] for k in (
        "layers", "vocab", "embed", "heads", "kv_heads", "head_dim", "mlp",
        "experts", "expert_mlp", "ssm_heads", "ssm_state", "ssm_inner",
        "conv", "seq", "pos",
    )},
}

ONE = {"data": 1, "model": 1}  # the mesh of one process
ORIGIN = {"data": 0, "model": 0}  # its one rank's coordinates


def _sizes(mesh: ClientMesh | None) -> dict:
    return ONE if mesh is None else mesh.axis_sizes


def _input_shardings(dims_tree: dict, shapes: dict, rules, mesh) -> dict:
    """The rules' spec of each step input."""
    return {k: R.logical_to_pspec(tuple(dims_tree[k]), tuple(shapes[k].shape),
                                  rules, _sizes(mesh)) for k in shapes}


def _param_shardings(model: Model, rules, mesh) -> dict:
    return model.param_pspecs(rules, _sizes(mesh))


def _cache_shardings(model: Model, cfg, cache: dict, rules, mesh) -> dict:
    """The rules' spec of each cache leaf (of the whole cache ``cache``);
    the host int ``length`` has spec ()."""
    axes = model.cache_axes(cfg)
    return {k: (R.logical_to_pspec(tuple(axes[k]), tuple(t.shape), rules,
                                   _sizes(mesh))
                if isinstance(t, torch.Tensor) else ())
            for k, t in cache.items()}


def meta_params(model: Model, blocks: dict | None = None) -> dict:
    """The parameter tree (a rank's ``blocks`` of it) as meta tensors,
    each leaf in its spec's dtype (``param_dtype`` unless the spec names
    one)."""
    dt = torch_dtype(model.cfg.param_dtype)
    paths, specs = tree_flatten(model.specs)
    shapes = ([s.shape for s in specs] if blocks is None else
              [tuple(b.stop - b.start for b in bl)
               for bl in tree_flatten(blocks)[1]])
    return tree_unflatten(paths, [
        torch.empty(shp, dtype=torch_dtype(s.dtype) if s.dtype else dt,
                    device="meta") for s, shp in zip(specs, shapes)])


def build_step(arch_cfg: ModelConfig, shape: InputShape,
               mesh: ClientMesh | None = None, *,
               dist_overrides: dict | None = None,
               variant: str = "default", donate: bool = False):
    """Returns dict(step, args, in_shardings, model, cfg, model_axis,
    blocks[, system, rules]).

    ``mesh``: a (data, model) client mesh (N = its data size, one client a
    data rank, as the reference's ``mesh_num_clients``); None is one
    process with one client.  A serve step runs over both axes (the
    module's docstring; ``data_axis`` the rank's ``mesh.data_axis()``,
    ``split`` what the rules put on it, "batch", "seq" or None, ``rows``
    and ``slots`` its rows of the batch and slots of a decode's cache).
    ``dist_overrides``: ``DistConfig`` fields
    (``upload_dtype``, ``accum_dtype``, ``state_dtype``, ...).
    ``donate``: the train step writes the new state into the old one's
    buffers (the counterpart of ``jax.jit(step, donate_argnums=0)``)."""
    if variant not in WARN_VARIANTS:
        raise ValueError(f"variant {variant!r} not in {WARN_VARIANTS}")
    cfg = resolve_cfg(arch_cfg, shape)
    model = build_model(cfg)
    tree, dims = input_specs(cfg, shape)
    sizes = _sizes(mesh)
    require_model_axis(cfg.family, sizes["model"])
    ma = None if mesh is None else mesh.model_axis()

    if shape.kind == "train":
        rules = RULES_TRAIN_DP if variant == "dp_client" else \
            R.RULES_TRAIN_CLIENT
        n = 1 if mesh is None else mesh_num_clients(mesh)
        dcfg = D.DistConfig(num_clients=n, **(dist_overrides or {}))
        sys_ = D.make_afl_train_system(model, cfg, mesh, dcfg, donate=donate,
                                       rules=rules)
        scal = torch.empty(n, dtype=torch.float32, device="meta")
        args = (sys_["abstract_state"](), tree, scal, scal, scal, scal)
        in_sh = (sys_["state_specs"], _input_shardings(dims, tree, rules, mesh),
                 (), (), (), ())
        return dict(step=sys_["step"], args=args, in_shardings=in_sh,
                    model=model, cfg=cfg, system=sys_, model_axis=ma,
                    rules=rules,
                    blocks=tree_unflatten(model.layout.paths,
                                          list(sys_["placement"].blocks)))

    rules = R.RULES_SERVE
    coords = ORIGIN if mesh is None else mesh.coords
    blocks = model.blocks(rules, sizes, coords)
    params = meta_params(model, blocks)
    p_sh = _param_shardings(model, rules, mesh)
    b_sh = _input_shardings(dims, tree, rules, mesh)
    da = None if mesh is None else mesh.data_axis()
    if shape.kind == "prefill":
        split = R.serve_split(shape.global_batch, shape.seq_len, sizes)
    else:
        max_seq = cache_max_seq(cfg, shape)
        split = R.serve_split(shape.global_batch, max_seq or None, sizes)
    # the rank's rows of each input where the batch is on data, else the
    # whole input (a prefill whose batch does not divide runs it whole)
    in_bl = (R.data_blocks(dims, tree, sizes, coords) if split == "batch"
             else {k: tuple(slice(0, n) for n in t.shape)
                   for k, t in tree.items()})
    local = {k: torch.empty(tuple(b.stop - b.start for b in in_bl[k]),
                            dtype=t.dtype, device="meta")
             for k, t in tree.items()}
    mkw = {} if ma is None else {"model_axis": ma}
    kw = (dict(mkw, data_axis=da) if split == "batch" and cfg.is_moe
          else mkw)
    if split == "seq" and cfg.num_heads:  # its block of the cache's slots
        kw = dict(kw, seq_axis=da)
    out = dict(model=model, cfg=cfg, model_axis=ma, blocks=blocks,
               data_axis=da, input_blocks=in_bl, sizes=sizes, coords=coords,
               split=split)
    if shape.kind == "prefill":
        if cfg.family == "vlm":
            from repro_torch.models import layers as L
            from repro_torch.models import transformer as T
            from repro_torch.models import vlm as V

            def run(params, batch):
                text = L.embed(params, cfg, batch["tokens"], ma)
                x = torch.cat([batch["vision_embeds"].to(cfg.activation_dtype),
                               text], dim=1)
                bsz, n_img = batch["vision_embeds"].shape[:2]
                grid = int(max(n_img, 1) ** 0.5) or 1
                pos = V.mrope_positions(bsz, n_img, batch["tokens"].shape[1],
                                        grid, x.device)
                return T.prefill(params, cfg, None, embeds=x, positions=pos,
                                 **kw)

        elif cfg.family == "audio":
            def run(params, batch):
                return model.prefill(params, cfg, batch["tokens"],
                                     frames=batch["frames"], **kw)

        else:
            def run(params, batch):
                return model.prefill(params, cfg, batch["tokens"], **kw)

        return dict(out, step=run, args=(params, local),
                    in_shardings=(p_sh, b_sh))

    # decode
    rows, slots = R.serve_block(shape.global_batch, max_seq or None, sizes,
                                coords)
    cache = model.init_cache(cfg, rows.stop - rows.start,
                             0 if slots is None else slots.stop - slots.start,
                             "meta", **mkw)
    c_sh = _cache_shardings(model, cfg, model.init_cache(
        cfg, shape.global_batch, max_seq, device="meta"), rules, mesh)

    def step(params, cache, token, pos):
        return model.decode_step(params, cfg, cache, token, int(pos), **kw)

    args = (params, cache, local["token"], tree["pos"])
    return dict(out, step=step, args=args, rows=rows, slots=slots,
                in_shardings=(p_sh, c_sh, b_sh["token"], ()))


def local_args(built: dict, args: tuple) -> tuple:
    """A rank's arguments of a serve step (``build_step``'s) cut out of
    the whole ones that one process's step takes (``materialize``'s, or a
    test's): its parameter blocks; a prefill's rows of its inputs (all of
    them where the batch does not divide); a decode's block of the cache
    on both axes (``data_cache``, then ``local_cache``), its rows of the
    token, the position."""
    model, ma = built["model"], built["model_axis"]
    params = local_params(model, args[0], built["blocks"])
    bl = built["input_blocks"]
    if len(args) == 2:  # a prefill's
        return params, {k: v[bl[k]].clone() for k, v in args[1].items()}
    cache = local_cache(model, data_cache(model, args[1], built["sizes"],
                                          built["coords"]), ma)
    return params, cache, args[2][bl["token"]].clone(), args[3]


def _filled(t: torch.Tensor, gen: torch.Generator, scale: float = 1.0):
    """``t`` filled in place with N(0, scale^2) values from ``gen`` (int8:
    uniform codes in [-127, 127]), drawn on the generator's device: in
    place where ``t`` lies there (a card's 60 GB cache block needs no
    draw beside it), else drawn and copied."""
    if t.device == gen.device:
        if t.dtype == torch.int8:
            return t.random_(-127, 128, generator=gen)
        return t.normal_(0.0, scale, generator=gen)
    if t.dtype == torch.int8:
        vals = torch.randint(-127, 128, t.shape, generator=gen,
                             device=gen.device, dtype=torch.int8)
    else:
        vals = torch.randn(t.shape, generator=gen, device=gen.device,
                           dtype=t.dtype)
        if scale != 1.0:
            vals.mul_(scale)
    return t.copy_(vals)


def _batch(tree: dict, cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Tokens and labels uniform in [0, vocab); bf16 ``vision_embeds`` and
    ``frames`` N(0, 0.02^2) (the scale of ``demo_batch``'s draws)."""
    out = {}
    for k, t in tree.items():
        if t.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                   device=gen.device, dtype=torch.int32
                                   ).to(device)
        else:
            out[k] = _filled(torch.empty(t.shape, dtype=t.dtype, device=device),
                             gen, 0.02)
    return out


def materialize(built: dict, shape: InputShape, gen: torch.Generator,
                device, mesh: ClientMesh | None = None) -> tuple:
    """``built["args"]`` as real tensors on ``device``, drawn from ``gen``:
    parameters through ``Model.init``; the batch through ``_batch``.

    Train: the round-0 state of the rank's clients on those parameters
    (``core/distributed.py::init_state``; ``mesh`` as the one the step was
    built over), every client in contact for ``FLConfig``'s mean contact
    time, channel gains from the wireless model, energy budgets uniform in
    ``FLConfig``'s range.  Decode: the cache through ``init_cache``, its
    values N(0, 1), with the positions before ``pos = seq_len - 1`` in its
    slots (a ring's slots the last ``max_seq`` of them), ``length`` their
    count, and ``pos`` a host int, as the port's decode takes it.  Over a
    mesh (``built``'s) the rank draws its own block: its parameter blocks,
    its rows of the inputs, and its block of the cache, whose slots hold
    the positions of the whole cache's slots they are."""
    from repro_torch.channel.wireless import WirelessChannel

    cfg, model = built["cfg"], built["model"]
    device = torch.device(device)
    params = model.init(gen, device, blocks=built["blocks"])
    if shape.kind == "train":
        sys_ = built["system"]
        dcfg = sys_["dcfg"]
        state = D.init_state(model, dcfg, mesh=mesh, device=device,
                             params=params, rules=built["rules"])
        del params
        n = dcfg.num_clients
        fl = FLConfig()
        seed = int(torch.randint(2**31 - 1, (1,), generator=gen,
                                 device=gen.device))
        lo, hi = fl.energy_budget
        scalars = (
            torch.ones(n), torch.full((n,), fl.mean_contact),
            torch.as_tensor(WirelessChannel(seed=seed).sample_gain(n)),
            lo + (hi - lo) * torch.rand(n, generator=gen, device=gen.device),
        )
        return (state, _batch(built["args"][1], cfg, gen, device),
                *(x.to(device=device, dtype=torch.float32) for x in scalars))
    if shape.kind == "prefill":
        return params, _batch(built["args"][1], cfg, gen, device)
    _, cache, token, _ = built["args"]
    b = token.shape[0]
    ma = built["model_axis"]
    window = cache_max_seq(cfg, shape)
    slots = built["slots"]
    cache = model.init_cache(cfg, b, 0 if slots is None else
                             slots.stop - slots.start, device,
                             **({} if ma is None else {"model_axis": ma}))
    pos = shape.seq_len - 1
    for key, t in cache.items():
        if key == "pos":
            # each global slot's position, then the rank's block of them
            whole = torch.full((b, window), -1, dtype=torch.int32,
                               device=device)
            past = torch.arange(max(0, pos - window), pos, device=device,
                                dtype=torch.int32)
            whole[:, past.long() % window] = past
            t.copy_(whole[:, slots])
        elif key == "length":
            cache[key] = min(pos, window)
        else:
            _filled(t, gen)
            if key.endswith("_scale"):
                t.abs_().mul_(1.0 / 127.0)
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                          device=gen.device, dtype=torch.int32).to(device)
    return params, cache, token, pos


def arg_bytes(tree) -> int:
    """Bytes of a step's arguments (meta or real): each tensor's; a host
    int (the train state's ``rnd``, a cache's ``length``) as the int32
    scalar the reference holds there; a generator or ``None`` none."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, int):
        return 4
    if isinstance(tree, dict):
        return sum(arg_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(arg_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(arg_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if tree is None or isinstance(tree, torch.Generator):
        return 0
    raise TypeError(f"no byte count for {type(tree).__name__}")
