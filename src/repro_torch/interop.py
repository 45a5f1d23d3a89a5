"""Carrying state between the reference package and the port.

The system has no weights: what the reference hands over is arrays
(samples, covariances, the (m, d, r) stack of local bases, a reference
basis, a subspace-iteration start ``v0``, wire payloads in bf16 or int8
with their f32 column scales, a ``Membership``'s mask).  They cross as
numpy arrays, so one set of inputs made from a numpy seed feeds both
packages; a bf16 array (numpy's ``ml_dtypes`` bfloat16) crosses bit for
bit.

For the models, ``lm_params_from_reference`` loads the reference's
parameter tree (as numpy arrays) into the port's ``LM`` or ``EncDec``, so
both packages compute the same function in the parity tests.
``reference_leaves`` is the one path map between the two, for every
family: each port leaf name (``blocks.3.mixer.wq``,
``decoder.1.cross_attn.wq``) with the reference's key path
(``['stages'][0]['block0']['mixer']['wq']``,
``['decoder']['cross_attn']['wq']``), its layer in that stacked leaf, and
the reference leaf's full shape and logical axes.  The
trainers decide weight decay (``decays``) and compressibility
(``optim.eigen_compress`` via ``launch.steps``) from the reference leaf,
not from the port's tensor: the reference stacks a
stage's layers, so a block's (d,) norm is an (L, d) leaf there.
``split_reference`` / ``join_reference`` move flat dicts of arrays
between the two namings, and ``opt_state_from_reference`` /
``opt_state_to_reference`` carry AdamW's and the eigen trainer's state.

Also the device rule of the port's entry points: ``resolve_device``
places work on the card unless the caller names the CPU, and raises when
asked for a card that is not there.  ``strict_fp32`` turns TF32 off,
because the reference computes in f32 and TF32 would cut the SVD, QR and
subspace-iteration products to about three digits.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping

import numpy as np
import torch

__all__ = [
    "from_reference", "to_numpy", "resolve_device", "strict_fp32",
    "lm_params_from_reference", "ReferenceLeaf", "reference_leaves", "decays",
    "split_reference", "join_reference", "opt_state_from_reference",
    "opt_state_to_reference",
]


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch finds no CUDA device; pass "
            "device='cpu' to run the port's plain PyTorch path"
        )
    return dev


def strict_fp32() -> None:
    """Keep float32 matrix products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def from_reference(
    arrays: Mapping[str, np.ndarray],
    *,
    device: str | torch.device,
    dtype: torch.dtype | None = None,
) -> dict[str, torch.Tensor]:
    """Copy named host arrays (numpy, or anything ``np.asarray`` takes,
    such as the reference's device arrays) onto ``device`` as tensors,
    optionally cast to ``dtype``."""
    dev = resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        host = np.array(arr, copy=True)
        if host.dtype.name == "bfloat16":  # no numpy dtype torch reads
            t = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(host)
        out[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor (bf16 widens to f32, which numpy has)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def lm_params_from_reference(values, cfg, *, device: str | torch.device,
                             param_dtype: torch.dtype | None = None):
    """The port's model for ``cfg`` (``LM``, or ``EncDec`` for an
    encoder-decoder) holding the reference's parameters.

    ``values`` is the reference's tree (``init_split(cfg, key)[0]``) with
    numpy leaves; every port leaf is read from its reference path and
    layer as ``reference_leaves`` maps them.  Projections are stored in
    ``param_dtype`` (default the config's dtype: the reference casts at
    every use; f32 keeps its values exactly, as training needs); norms and
    the leaves the reference uses in f32 stay f32.
    """
    # Function-level import: the models import the kernels, which this
    # module's other helpers must not pull in.
    from repro_torch.models.registry import model_class

    model = model_class(cfg)(cfg, device=resolve_device(device), param_dtype=param_dtype)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, leaf in reference_leaves(cfg).items():
            arr = _at_path(values, leaf.path)
            if leaf.layer is not None:
                arr = arr[leaf.layer]
            host = torch.tensor(np.asarray(arr, dtype=np.float32))  # a copy
            params[name].copy_(host.reshape(params[name].shape))
    return model


def _at_path(tree, path: str):
    """The leaf of a nested dict / list at a ``jax.tree_util.keystr`` path
    such as ``['stages'][0]['block0']['mixer']['wq']``."""
    for key, idx in re.findall(r"\['([^']*)'\]|\[(\d+)\]", path):
        tree = tree[key] if key else tree[int(idx)]
    return tree


@dataclasses.dataclass(frozen=True)
class ReferenceLeaf:
    """Where a port leaf lives in the reference's parameter tree."""

    path: str  # the reference's key path (jax.tree_util.keystr)
    layer: int | None  # index along the stacked layer axis, None if unstacked
    shape: tuple  # the reference leaf's full shape
    axes: tuple  # its logical axes

    @property
    def layer_shape(self) -> tuple:
        """One layer's slice of the reference leaf (the whole leaf if not
        stacked): the port tensor's shape before any flattening."""
        return self.shape if self.layer is None else self.shape[1:]


_ATTENTION_AXES = {
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
}


def _attention_leaves(cfg) -> dict[str, tuple]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd), "wo": (h, hd, d)}
    return {n: (shapes[n], _ATTENTION_AXES[n]) for n in shapes}


def _mlp_leaves(cfg) -> dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    out = {"wi": ((d, f), ("embed", "mlp")), "wo": ((f, d), ("mlp", "embed"))}
    if cfg.gated_mlp:
        out["wg"] = ((d, f), ("embed", "mlp"))
    return out


def _encdec_leaves(cfg) -> dict[str, ReferenceLeaf]:
    """``repro/models/encdec.py::init_encdec``: embed (V_pad, d), unembed
    (d, V_pad), enc_norm / dec_norm (d,), and the encoder's and decoder's
    layers stacked (L, ...): ``encoder/{norm1, attn, norm2, mlp}``,
    ``decoder/{norm1, self_attn, norm_x, cross_attn, norm2, mlp}``."""
    d, vp = cfg.d_model, cfg.padded_vocab
    out = {"embed": ReferenceLeaf("['embed']", None, (vp, d), ("vocab", "embed")),
           "unembed": ReferenceLeaf("['unembed']", None, (d, vp), ("embed", "vocab")),
           "enc_norm": ReferenceLeaf("['enc_norm']", None, (d,), ("embed",)),
           "dec_norm": ReferenceLeaf("['dec_norm']", None, (d,), ("embed",))}
    norm = {"": ((d,), ("embed",))}
    stacks = (
        ("encoder", cfg.num_encoder_layers,
         (("norm1", norm), ("attn", _attention_leaves(cfg)), ("norm2", norm),
          ("mlp", _mlp_leaves(cfg)))),
        ("decoder", cfg.num_layers,
         (("norm1", norm), ("self_attn", _attention_leaves(cfg)), ("norm_x", norm),
          ("cross_attn", _attention_leaves(cfg)), ("norm2", norm),
          ("mlp", _mlp_leaves(cfg)))),
    )
    for stack, count, parts in stacks:
        for layer in range(count):
            for part, leaves in parts:
                for leaf, (shape, axes) in leaves.items():
                    name = f"{part}.{leaf}" if leaf else part
                    keys = "".join(f"['{key}']" for key in name.split("."))
                    out[f"{stack}.{layer}.{name}"] = ReferenceLeaf(
                        f"['{stack}']{keys}", layer, (count, *shape), ("layers", *axes))
    return out


def reference_leaves(cfg) -> dict[str, ReferenceLeaf]:
    """Port leaf name -> ``ReferenceLeaf`` for every parameter of the model
    of ``cfg``: an encoder-decoder's (``_encdec_leaves``), or the LM's
    (``repro/models/lm.py::init_lm`` and ``layers.init_*``):
    embed (V_pad, d), unembed (d, V_pad), a VLM's patch_proj
    (patch_embed_dim, d), final_norm (d,), and per stage,
    stacked over its count L, each block's norm1 / norm2 (L, d), its
    mixer's leaves by kind and the MLP's wi / wg (L, d, f) and wo (L, f, d),
    or an MoE config's router (L, d, e), wi / wg (L, e, d, f) and wo
    (L, e, f, d).
    Mixers: attention (``attn`` and ``local_attn``) wq (L, d, h, hd),
    wk / wv (L, d, kv, hd), wo (L, h, hd, d); RG-LRU wx / wgate (L, d, w),
    conv (L, K, w), wa / wi (L, w, w), wo (L, w, d), lam (L, w); SSD wx /
    wz (L, d, di), wb / wc (L, d, N), wdt (L, d, H), conv (L, K, di), wo
    (L, di, d), a_log / dt_bias / dskip (L, H)."""
    if cfg.is_encoder_decoder:
        return _encdec_leaves(cfg)
    d, f = cfg.d_model, cfg.d_ff
    out = {"embed": ReferenceLeaf("['embed']", None, (cfg.padded_vocab, d),
                                  ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["unembed"] = ReferenceLeaf("['unembed']", None, (d, cfg.padded_vocab),
                                       ("embed", "vocab"))
    if cfg.num_patches:
        out["patch_proj"] = ReferenceLeaf("['patch_proj']", None,
                                          (cfg.patch_embed_dim, d), (None, "embed"))
    out["final_norm"] = ReferenceLeaf("['final_norm']", None, (d,), ("embed",))
    attention = _attention_leaves(cfg)
    w, k = cfg.lru_width or d, cfg.conv_width
    di, nh, ns = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state_dim
    mixers = {
        "attn": attention,
        "local_attn": attention,
        "rglru": {
            "wx": ((d, w), ("embed", "mlp")),
            "wgate": ((d, w), ("embed", "mlp")),
            "conv": ((k, w), (None, "mlp")),
            "wa": ((w, w), ("mlp", None)),
            "wi": ((w, w), ("mlp", None)),
            "wo": ((w, d), ("mlp", "embed")),
            "lam": ((w,), ("mlp",)),
        },
        "ssd": {
            "wx": ((d, di), ("embed", "mlp")),
            "wz": ((d, di), ("embed", "mlp")),
            "wb": ((d, ns), ("embed", None)),
            "wc": ((d, ns), ("embed", None)),
            "wdt": ((d, nh), ("embed", None)),
            "conv": ((k, di), (None, "mlp")),
            "wo": ((di, d), ("mlp", "embed")),
            "a_log": ((nh,), (None,)),
            "dt_bias": ((nh,), (None,)),
            "dskip": ((nh,), (None,)),
        },
    }
    mlp = {}
    if f > 0 and cfg.is_moe:
        e = cfg.num_experts
        mlp = {"norm2": ((d,), ("embed",)),
               "mlp.router": ((d, e), ("embed", None)),
               "mlp.wi": ((e, d, f), ("experts", "embed", "mlp")),
               "mlp.wg": ((e, d, f), ("experts", "embed", "mlp")),
               "mlp.wo": ((e, f, d), ("experts", "mlp", "embed"))}
    elif f > 0:
        mlp = {"norm2": ((d,), ("embed",)),
               **{f"mlp.{n}": v for n, v in _mlp_leaves(cfg).items()}}
    b = 0
    for s_idx, (pattern, count) in enumerate(cfg.stages()):
        for layer in range(count):
            for j, kind in enumerate(pattern):
                block = {"norm1": ((d,), ("embed",)),
                         **{f"mixer.{n}": v for n, v in mixers[kind].items()}, **mlp}
                for leaf, (shape, axes) in block.items():
                    keys = "".join(f"['{key}']" for key in leaf.split("."))
                    out[f"blocks.{b}.{leaf}"] = ReferenceLeaf(
                        f"['stages'][{s_idx}]['block{j}']{keys}", layer,
                        (count, *shape), ("layers", *axes))
                b += 1
    return out


def decays(cfg):
    """The weight-decay rule for the model of ``cfg``: ``decays(name, p)``
    is True when the reference's leaf has two or more dimensions (the
    reference's ``p.ndim >= 2``): every per-block leaf, norms and the
    recurrent mixers' vectors included (RG-LRU's ``lam`` and SSD's
    ``a_log``, ``dt_bias``, ``dskip`` are stacked (L, w) / (L, H) there,
    even where a stage has L = 1; the enc-dec's layer norms (L, d)), the
    embeddings and ``patch_proj``; not ``final_norm``, ``enc_norm`` or
    ``dec_norm``."""
    leaves = reference_leaves(cfg)
    return lambda name, p=None: len(leaves[name].shape) >= 2


def split_reference(flat: Mapping[str, np.ndarray], cfg, *,
                    lead: int = 0) -> dict[str, np.ndarray]:
    """Reference key path -> array, to port leaf name -> array: each
    stacked leaf unstacked along its layer axis (after ``lead`` leading
    axes, such as the eigen error feedback's shard axis) and each layer's
    slice reshaped to the port tensor's shape.  Paths absent from
    ``flat`` are skipped."""
    out = {}
    for name, leaf in reference_leaves(cfg).items():
        if leaf.path not in flat:
            continue
        arr = np.asarray(flat[leaf.path])
        head = arr.shape[:lead]
        if leaf.layer is not None:
            arr = arr[(slice(None),) * lead + (leaf.layer,)]
        out[name] = arr.reshape(head + _port_shape(leaf))
    return out


def _port_shape(leaf: ReferenceLeaf) -> tuple:
    """The port tensor's shape: a layer's slice, its head axes flattened
    into a matrix for the attention projections (the MoE's (e, ., .)
    expert leaves keep theirs)."""
    shape = leaf.layer_shape
    if leaf.axes[-1] == "head_dim":  # wq / wk / wv (d, h, hd)
        return (shape[0], shape[1] * shape[2])
    if leaf.axes[-2:] == ("head_dim", "embed"):  # wo (h, hd, d)
        return (shape[0] * shape[1], shape[2])
    return shape


def join_reference(named: Mapping[str, object], cfg, *,
                   lead: int = 0) -> dict[str, np.ndarray]:
    """The inverse of ``split_reference``: port leaf name -> array (or
    tensor) to reference key path -> numpy array, re-stacking the layers
    and reshaping to the reference leaf's shape.  All layers of a stacked
    leaf must be present."""
    leaves = reference_leaves(cfg)
    groups: dict[str, list] = {}
    for name, val in named.items():
        leaf = leaves[name]
        arr = to_numpy(val) if isinstance(val, torch.Tensor) else np.asarray(val)
        head = arr.shape[:lead]
        groups.setdefault(leaf.path, []).append(
            (leaf, arr.reshape(head + leaf.layer_shape)))
    out = {}
    for path, items in groups.items():
        leaf = items[0][0]
        if leaf.layer is None:
            out[path] = items[0][1]
            continue
        items.sort(key=lambda it: it[0].layer)
        if [it[0].layer for it in items] != list(range(leaf.shape[0])):
            raise ValueError(f"{path}: layers {[it[0].layer for it in items]} of "
                             f"{leaf.shape[0]}")
        out[path] = np.stack([a for _, a in items], axis=lead)
    return out


def _tensors(arrays: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in arrays.items()}


def opt_state_from_reference(ref_opt, cfg, *, device, shard: int | None = None):
    """The reference's optimizer state (numpy leaves) as the port's.

    AdamW: ``{"m": {path: arr}, "v": {path: arr}, "step"}`` (the moment
    trees flattened by key path).  Eigen trainer:
    ``{"full_m", "full_v", "eigen": {path: {"basis", "m", "v", "err",
    "initialized"}}, "step"}``.  Eigen leaves are unstacked per layer (the
    reference's matmul views are the port's matrices already); ``err``
    keeps its shard axis (the stacked form), or with ``shard`` is that
    shard's slice (one rank of the collective form)."""
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(ref_opt["step"])), dtype=torch.int32)
    if "eigen" not in ref_opt:
        return {"m": _tensors(split_reference(ref_opt["m"], cfg), dev),
                "v": _tensors(split_reference(ref_opt["v"], cfg), dev), "step": step}
    eigen = {}
    for name, leaf in reference_leaves(cfg).items():
        st = ref_opt["eigen"].get(leaf.path)
        if st is None:
            continue
        pick = (lambda a, lead=0: a if leaf.layer is None
                else a[(slice(None),) * lead + (leaf.layer,)])
        err = pick(np.asarray(st["err"]), 1)
        if shard is not None:
            err = err[shard]
        eigen[name] = {
            **_tensors({k: pick(np.asarray(st[k])) for k in ("basis", "m", "v")}, dev),
            "err": _tensors({"e": err}, dev)["e"],
            "initialized": torch.tensor(bool(np.asarray(st["initialized"]))),  # host flag
        }
    return {"full_m": _tensors(split_reference(ref_opt["full_m"], cfg), dev),
            "full_v": _tensors(split_reference(ref_opt["full_v"], cfg), dev),
            "eigen": eigen, "step": step}


def opt_state_to_reference(opt, cfg) -> dict:
    """The inverse of ``opt_state_from_reference`` (numpy leaves, the
    reference's key paths and stacked shapes), for comparisons.  A
    collective-form state's ``err`` has no shard axis."""
    step = np.asarray(int(opt["step"]), dtype=np.int32)
    if "eigen" not in opt:
        return {"m": join_reference(opt["m"], cfg), "v": join_reference(opt["v"], cfg),
                "step": step}
    leaves = reference_leaves(cfg)
    eigen: dict[str, dict] = {}
    for name, st in opt["eigen"].items():
        leaf = leaves[name]
        eigen.setdefault(leaf.path, {"_leaf": leaf, "items": []})["items"].append(
            (leaf.layer, st))
    out = {}
    for path, grp in eigen.items():
        items = sorted(grp["items"], key=lambda it: it[0] or 0)
        stacked = grp["_leaf"].layer is not None
        st0 = items[0][1]
        rec = {}
        for k in ("basis", "m", "v", "err"):
            arrs = [to_numpy(st[k]) for _, st in items]
            lead = st0["err"].dim() - 2 if k == "err" else 0
            rec[k] = np.stack(arrs, axis=lead) if stacked else arrs[0]
        rec["initialized"] = np.asarray(bool(st0["initialized"]))
        out[path] = rec
    return {"full_m": join_reference(opt["full_m"], cfg),
            "full_v": join_reference(opt["full_v"], cfg), "eigen": out, "step": step}
