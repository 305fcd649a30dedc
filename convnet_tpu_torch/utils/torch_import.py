"""Import PyTorch reference checkpoints into the port's models (counterpart
of convnet_tpu/utils/torch_import.py).

A checkpoint trained with eladhoffer/convNet.pytorch loads into the
equivalent model of the port, to be evaluated, fine-tuned or served.

Pairing (no torch module names are assumed):

1. Walk the model's module tree in definition order and collect its
   *parameterized units*, Conv2d, Linear and BatchNorm2d, each with its
   prefix in the model's ``state_dict``.
2. Group the torch ``state_dict`` (registration order) into the same kinds:
   a 4-D ``*.weight`` is a conv (+ optional 1-D sibling bias), a 2-D
   ``*.weight`` a linear, a 1-D ``*.weight`` or a ``running_mean`` a BN
   (``num_batches_tracked`` is ignored).
3. Pair the two sequences in order. On a kind mismatch, look ahead a small
   window on the torch side (modules are sometimes *registered* at another
   point than they are *executed*, e.g. a residual downsample) and take the
   first kind- and shape-compatible unit.
4. Check every shape and fail loudly, naming both sides, on any mismatch or
   leftover units.

The port's layouts are torch's (conv OIHW, linear (out, in)), so no
transpose is needed, except for a linear that consumes a flattened conv map:
torch flattens (C, H, W), the port's NHWC flattens (H, W, C).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from convnet_tpu_torch.nn import BatchNorm2d, Conv2d, GlobalAvgPool, Linear


def collect_units(model):
    """[(kind, prefix, module, pooled)] in definition order; ``pooled``: a
    linear reached after a GlobalAvgPool with no conv between (its input
    has no spatial layout to permute)."""
    units = []
    pooled = [False]

    def walk(mod, prefix):
        if isinstance(mod, Conv2d):
            pooled[0] = False
            units.append(("conv", prefix, mod, False))
            return
        if isinstance(mod, Linear):
            units.append(("linear", prefix, mod, pooled[0]))
            return
        if isinstance(mod, BatchNorm2d):
            units.append(("bn", prefix, mod, False))
            return
        if isinstance(mod, GlobalAvgPool):
            pooled[0] = True
            return
        for name, child in mod.named_children():
            walk(child, f"{prefix}.{name}" if prefix else name)

    walk(model, "")
    return units


def _group_torch_units(state_dict):
    """Group a torch state_dict into (kind, prefix, tensors) units, in
    registration order."""
    by_prefix = {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        prefix, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        by_prefix.setdefault(prefix, {})[leaf] = np.asarray(
            val.detach().cpu().float().numpy()
            if isinstance(val, torch.Tensor) else val)
    units = []
    for prefix, leaves in by_prefix.items():   # first-seen order
        w = leaves.get("weight")
        if w is not None and w.ndim == 4:
            units.append(("conv", prefix, {"w": w, "b": leaves.get("bias")}))
        elif w is not None and w.ndim == 2:
            units.append(("linear", prefix,
                          {"w": w, "b": leaves.get("bias")}))
        elif "running_mean" in leaves or (w is not None and w.ndim == 1):
            units.append(("bn", prefix, {
                "scale": w, "bias": leaves.get("bias"),
                "mean": leaves.get("running_mean"),
                "var": leaves.get("running_var")}))
        else:
            raise ValueError(
                f"unrecognized state_dict entry group '{prefix}': "
                f"{sorted(leaves)} with shapes "
                f"{[v.shape for v in leaves.values()]}")
    return units


def _shape(unit):
    """The shape a unit of either side is paired by."""
    kind, _, body = unit[:3]
    if isinstance(body, torch.nn.Module):
        if kind == "bn":
            return tuple(body.running_mean.shape)
        return tuple(body.weight.shape)
    if kind == "bn":
        ref = body["mean"] if body["mean"] is not None else body["scale"]
        return tuple(ref.shape)
    return tuple(body["w"].shape)


def pair_units(our_units, torch_units, lookahead=6):
    """Pair the model's units with torch units in order, with a bounded
    look-ahead on the torch side for registration-order differences.
    Returns [(our_unit, torch_unit)]."""
    remaining = list(torch_units)
    pairs = []
    for ou in our_units:
        kind = ou[0]
        hit = None
        for j, tu in enumerate(remaining[:lookahead]):
            if tu[0] == kind and _shape(tu) == _shape(ou):
                hit = j
                break
        if hit is None:
            near = [(t[0], t[1]) for t in remaining[:lookahead]]
            raise ValueError(
                f"no torch unit matches {kind} at {ou[1]} (shape "
                f"{_shape(ou)}); next torch units: {near}")
        pairs.append((ou, remaining.pop(hit)))
    if remaining:
        raise ValueError(
            "torch state_dict has unmatched units: "
            + ", ".join(f"{k}:{n}" for k, n, _ in remaining[:8]))
    return pairs


def _split_aux(units):
    trunk = [u for u in units if "aux" not in u[1].lower()]
    aux = [u for u in units if "aux" in u[1].lower()]
    return trunk, aux


def _paired(state_dict, model, importing):
    ours = collect_units(model)
    theirs = _group_torch_units(state_dict)
    # auxiliary heads are paired by name, not position: torch registers
    # them mid-trunk, the models define them after the classifier
    ours_trunk, ours_aux = _split_aux(ours)
    theirs_trunk, theirs_aux = _split_aux(theirs)
    if importing and theirs_aux and not ours_aux:
        warnings.warn(
            f"state_dict carries {len(theirs_aux)} auxiliary-head units "
            f"({sorted({u[1].split('.')[0] for u in theirs_aux})}) but the "
            f"model has no aux classifiers; dropping them (training-only "
            f"heads: eval logits are unaffected)")
        theirs_aux = []
    ours, theirs = ours_trunk + ours_aux, theirs_trunk + theirs_aux
    if len(ours) != len(theirs):
        raise ValueError(
            f"unit count mismatch: model has {len(ours)} parameterized "
            f"units ({len(ours_aux)} aux), state_dict has {len(theirs)} "
            f"({len(theirs_aux)} aux)")
    return pair_units(ours, theirs)


def _flatten_permutation(w, channels, to_nhwc):
    """A linear's (out, in) weight over a flattened (C, H, W) map, its input
    columns reordered to (H, W, C) (``to_nhwc``) or back."""
    if w.shape[1] % channels:
        raise ValueError(f"linear in_features {w.shape[1]} is not a multiple "
                         f"of the preceding conv's {channels} channels")
    spatial = w.shape[1] // channels
    side = int(round(spatial ** 0.5))
    if side * side != spatial:
        raise ValueError(f"linear: cannot infer a square spatial size from "
                         f"{spatial}")
    if to_nhwc:
        return (w.reshape(w.shape[0], channels, side, side)
                .transpose(0, 2, 3, 1).reshape(w.shape[0], -1))
    return (w.reshape(w.shape[0], side, side, channels)
            .transpose(0, 3, 1, 2).reshape(w.shape[0], -1))


def import_torch_state_dict(state_dict, model):
    """The model's ``state_dict`` with every conv, linear and BN entry taken
    from the torch ``state_dict`` (dtypes as the model's). Raises
    ValueError on any structural mismatch. A torch conv bias (the port's
    convs have none) folds exactly into the next BN's running mean:
    BN(conv + b | mean μ) == BN(conv | mean μ − b). A checkpoint with
    auxiliary heads imports into a model without them by dropping the heads,
    with a warning."""
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def put(key, value):
        out[key] = torch.as_tensor(np.ascontiguousarray(value),
                                   dtype=out[key].dtype)

    def key(prefix, leaf):
        return f"{prefix}.{leaf}" if prefix else leaf

    pending_bias = None      # (torch name, bias) of a bias-carrying conv
    last_conv_out = None     # out-channels of the most recent conv
    for (kind, prefix, mod, pooled), (_, tname, tp) in _paired(
            state_dict, model, importing=True):
        if pending_bias is not None and kind != "bn":
            raise ValueError(
                f"torch conv '{pending_bias[0]}' has a bias, model conv has "
                f"none, and the next unit is not a BatchNorm to fold it into")
        if kind == "conv":
            last_conv_out = int(tp["w"].shape[0])
            put(key(prefix, "weight"), tp["w"])
            if tp.get("b") is not None:
                pending_bias = (tname, tp["b"])
        elif kind == "linear":
            w = tp["w"]
            if last_conv_out and not pooled and w.shape[1] != last_conv_out:
                w = _flatten_permutation(w, last_conv_out, to_nhwc=True)
            last_conv_out = None
            put(key(prefix, "weight"), w)
            if tp.get("b") is not None:
                put(key(prefix, "bias"), tp["b"])
        else:
            if tp.get("scale") is not None:
                put(key(prefix, "weight"), tp["scale"])
            if tp.get("bias") is not None:
                put(key(prefix, "bias"), tp["bias"])
            if tp.get("mean") is not None:
                mean = tp["mean"]
                if pending_bias is not None:
                    if pending_bias[1].shape != mean.shape:
                        raise ValueError(
                            f"cannot fold bias of torch conv "
                            f"'{pending_bias[0]}' (shape "
                            f"{pending_bias[1].shape}) into BN '{tname}' "
                            f"(features {mean.shape})")
                    mean = mean - pending_bias[1]
                    pending_bias = None
                put(key(prefix, "running_mean"), mean)
                put(key(prefix, "running_var"), tp["var"])
            elif pending_bias is not None:
                raise ValueError(
                    f"torch conv '{pending_bias[0]}' bias needs BN running "
                    f"stats to fold into, but BN '{tname}' has none")
    if pending_bias is not None:
        raise ValueError(f"torch conv '{pending_bias[0]}' has a bias with no "
                         f"following BN to fold it into")
    return out


def export_into_torch_state_dict(template_state_dict, model):
    """The inverse of :func:`import_torch_state_dict`: a torch state_dict
    *template* (e.g. ``reference_model.state_dict()``) filled with this
    model's weights. Returns a new dict of numpy arrays keyed like the
    template; load it with ``reference_model.load_state_dict({k:
    torch.tensor(v) ...})``. Conv biases of the template cannot be
    reconstructed (the port's convs have none) and are emitted as zeros."""
    out = {k: np.asarray(v.detach().cpu().numpy()
                         if isinstance(v, torch.Tensor) else v)
           for k, v in template_state_dict.items()}

    def host(t):
        return t.detach().float().cpu().numpy()

    last_conv_out = None
    for (kind, _, mod, pooled), (_, prefix, tp) in _paired(
            template_state_dict, model, importing=False):
        def key(leaf):
            return f"{prefix}.{leaf}" if prefix else leaf
        if kind == "conv":
            w = host(mod.weight)
            last_conv_out = w.shape[0]
            out[key("weight")] = w
            if tp.get("b") is not None:
                out[key("bias")] = np.zeros(w.shape[0], np.float32)
        elif kind == "linear":
            w = host(mod.weight)
            if last_conv_out and not pooled and w.shape[1] != last_conv_out:
                w = _flatten_permutation(w, last_conv_out, to_nhwc=False)
            last_conv_out = None
            out[key("weight")] = w
            if tp.get("b") is not None:
                out[key("bias")] = host(mod.bias)
        else:
            if tp.get("scale") is not None:
                out[key("weight")] = host(mod.weight)
                out[key("bias")] = host(mod.bias)
            if tp.get("mean") is not None:
                out[key("running_mean")] = host(mod.running_mean)
                out[key("running_var")] = host(mod.running_var)
    return out


def read_torch_checkpoint(path):
    """(state_dict, meta) of a reference checkpoint file
    (``checkpoint.pth.tar`` / ``model_best.pth.tar``: a pickled dict with a
    ``state_dict`` key, or a bare state_dict); meta holds its other entries
    (epoch, best_prec1, ...). DataParallel's ``module.`` prefix is
    removed."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
        meta = {k: v for k, v in ckpt.items() if k != "state_dict"}
    else:
        sd, meta = ckpt, {}
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    return sd, meta


def load_torch_checkpoint(path, model):
    """Loads a reference checkpoint file into ``model`` in place. Returns
    (the model's new state_dict, meta with epoch / best_prec1 where the file
    has them)."""
    sd, meta = read_torch_checkpoint(path)
    state_dict = import_torch_state_dict(sd, model)
    model.load_state_dict(state_dict)
    return state_dict, meta
