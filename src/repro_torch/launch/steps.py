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
step's parameters and cache (every family's tensor-parallel layers
compute on them).
A serve step runs on a mesh of data 1 (its model axis across the cards);
data above 1 raises (``launch/mesh.py::SERVE_DATA_ITEM``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import FLConfig, InputShape, ModelConfig
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import (SERVE_DATA_ITEM, ClientMesh,
                                     mesh_num_clients, require_model_axis)
from repro_torch.models.registry import Model, build_model, input_specs
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
    blocks[, system]).

    ``mesh``: a (data, model) client mesh (N = its data size, one client a
    data rank, as the reference's ``mesh_num_clients``); None is one
    process with one client.  A serve step runs over the mesh's model axis
    and needs data 1.  ``dist_overrides``: ``DistConfig`` fields
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
                    blocks=tree_unflatten(model.layout.paths,
                                          list(sys_["placement"].blocks)))

    if sizes["data"] > 1:
        raise NotImplementedError(
            f"a serve step over a data axis of {sizes['data']} is not "
            f"ported ({SERVE_DATA_ITEM})")
    rules = R.RULES_SERVE
    blocks = model.blocks(rules, sizes,
                          ORIGIN if mesh is None else mesh.coords)
    params = meta_params(model, blocks)
    p_sh = _param_shardings(model, rules, mesh)
    b_sh = _input_shardings(dims, tree, rules, mesh)
    kw = {} if ma is None else {"model_axis": ma}
    out = dict(model=model, cfg=cfg, model_axis=ma, blocks=blocks)
    if shape.kind == "prefill":
        if cfg.family == "vlm":
            from repro_torch.models import layers as L
            from repro_torch.models import transformer as T
            from repro_torch.models import vlm as V

            def step(params, batch):
                text = L.embed(params, cfg, batch["tokens"], ma)
                x = torch.cat([batch["vision_embeds"].to(cfg.activation_dtype),
                               text], dim=1)
                bsz, n_img = batch["vision_embeds"].shape[:2]
                grid = int(max(n_img, 1) ** 0.5) or 1
                pos = V.mrope_positions(bsz, n_img, batch["tokens"].shape[1],
                                        grid, x.device)
                return T.prefill(params, cfg, None, embeds=x, positions=pos,
                                 model_axis=ma)

        elif cfg.family == "audio":
            def step(params, batch):
                return model.prefill(params, cfg, batch["tokens"],
                                     frames=batch["frames"], **kw)

        else:
            def step(params, batch):
                return model.prefill(params, cfg, batch["tokens"], **kw)

        return dict(out, step=step, args=(params, tree),
                    in_shardings=(p_sh, b_sh))

    # decode
    max_seq = cache_max_seq(cfg, shape)
    cache = model.init_cache(cfg, shape.global_batch, max_seq, device="meta",
                             **kw)
    c_sh = _cache_shardings(model, cfg, model.init_cache(
        cfg, shape.global_batch, max_seq, device="meta"), rules, mesh)

    def step(params, cache, token, pos):
        return model.decode_step(params, cfg, cache, token, int(pos), **kw)

    args = (params, cache, tree["token"], tree["pos"])
    return dict(out, step=step, args=args,
                in_shardings=(p_sh, c_sh, b_sh["token"], ()))


def _filled(t: torch.Tensor, gen: torch.Generator, scale: float = 1.0):
    """``t`` filled in place with N(0, scale^2) values from ``gen`` (int8:
    uniform codes in [-127, 127]), drawn on the generator's device."""
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
    count, and ``pos`` a host int, as the port's decode takes it."""
    from repro_torch.channel.wireless import WirelessChannel

    cfg, model = built["cfg"], built["model"]
    device = torch.device(device)
    params = model.init(gen, device, blocks=built["blocks"])
    if shape.kind == "train":
        sys_ = built["system"]
        dcfg = sys_["dcfg"]
        state = D.init_state(model, dcfg, mesh=mesh, device=device,
                             params=params)
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
    cache = model.init_cache(cfg, b, cache_max_seq(cfg, shape), device,
                             **({} if ma is None else {"model_axis": ma}))
    pos = shape.seq_len - 1
    for key, t in cache.items():
        if key == "pos":
            slots = t.shape[1]
            past = torch.arange(max(0, pos - slots), pos, device=device,
                                dtype=torch.int32)
            t[:, past.long() % slots] = past
        elif key == "length":
            cache[key] = min(pos, cache_max_seq(cfg, shape))
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
