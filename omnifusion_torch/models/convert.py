"""Convert the JAX package's model variables to the port's state dict.

``state_dict_from_jax(variables)`` takes the variables of a SphericalFusion,
a SphericalFusionIterative or a SphericalFusionSeg as a nested mapping of
arrays (``{"params": ..., "batch_stats": ...}``, numpy or anything
``np.asarray`` reads) and
returns the port's state dict: the upstream checkpoint's key names (the
names ``omnifusion_tpu/models/torch_export.py`` writes) with 4-D conv
kernels (O, I, kh, kw), plus ``up_proj.{weight,bias}`` where the model has
that projection, and without the token projection and the transformer where
the model has none (``use_transformer=False``). The tree says which model
it is: an iterative one has ``mlp_points1`` and ``mlp_points2``, and its
token projection goes to ``down1``; a segmentation one has the one-shot
model's tree with a ``pred`` of ``num_classes`` outputs. The result loads
into ``omnifusion_torch.models.SphericalFusion``, ``SphericalFusionIterative``
or ``SphericalFusionSeg`` with strict=True.

No JAX import: the mapping is names and axes only.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _conv_w(kernel) -> torch.Tensor:
    """(kh, kw, I, O) -> (O, I, kh, kw)."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _linear_w(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (1, 0)))


def _bn(sd, name, params, stats):
    sd[f"{name}.weight"] = _t(params["scale"])
    sd[f"{name}.bias"] = _t(params["bias"])
    sd[f"{name}.running_mean"] = _t(stats["mean"])
    sd[f"{name}.running_var"] = _t(stats["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _encoder(sd, p, s):
    sd["conv1.weight"] = _conv_w(p["conv1"]["kernel"])
    _bn(sd, "bn1", p["bn1"], s["bn1"])
    stage = 1
    while f"layer{stage}" in p:
        b = 0
        while str(b) in p[f"layer{stage}"]:
            bp = p[f"layer{stage}"][str(b)]
            bs = s[f"layer{stage}"][str(b)]
            t = f"layer{stage}.{b}"
            sd[f"{t}.conv1.weight"] = _conv_w(bp["conv1"]["kernel"])
            _bn(sd, f"{t}.bn1", bp["bn1"], bs["bn1"])
            sd[f"{t}.conv2.weight"] = _conv_w(bp["conv2"]["kernel"])
            _bn(sd, f"{t}.bn2", bp["bn2"], bs["bn2"])
            if "downsample_conv" in bp:
                sd[f"{t}.downsample.0.weight"] = _conv_w(bp["downsample_conv"]["kernel"])
                _bn(sd, f"{t}.downsample.1", bp["downsample_bn"], bs["downsample_bn"])
            b += 1
        stage += 1


def _transformer(sd, tp):
    sd["transformer.pos_emb"] = _t(tp["pos_emb"])
    sd["transformer.encoder_norm.weight"] = _t(tp["encoder_norm"]["scale"])
    sd["transformer.encoder_norm.bias"] = _t(tp["encoder_norm"]["bias"])
    i = 0
    while f"layer_{i}" in tp:
        lp = tp[f"layer_{i}"]
        t = f"transformer.layer.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{t}.{norm}.weight"] = _t(lp[norm]["scale"])
            sd[f"{t}.{norm}.bias"] = _t(lp[norm]["bias"])
        sd[f"{t}.attn.q.weight"] = _linear_w(lp["attn"]["q"]["kernel"])
        sd[f"{t}.attn.kv.weight"] = _linear_w(lp["attn"]["kv"]["kernel"])
        sd[f"{t}.attn.proj.weight"] = _linear_w(lp["attn"]["proj"]["kernel"])
        sd[f"{t}.attn.proj.bias"] = _t(lp["attn"]["proj"]["bias"])
        for fc in ("fc1", "fc2"):
            sd[f"{t}.mlp.{fc}.weight"] = _linear_w(lp["mlp"][fc]["kernel"])
            sd[f"{t}.mlp.{fc}.bias"] = _t(lp["mlp"][fc]["bias"])
        i += 1


def _trunk(sd, p, s, down_name="down"):
    _encoder(sd, p["encoder"], s["encoder"])
    for conv, name in (("down", down_name), ("up_proj", "up_proj")):
        if conv in p:
            sd[f"{name}.weight"] = _conv_w(p[conv]["kernel"])
            sd[f"{name}.bias"] = _t(p[conv]["bias"])
    if "transformer" in p:  # not under use_transformer=False
        _transformer(sd, p["transformer"])
    for stage in ("0_0", "0_1", "1_0", "1_1", "2_0", "2_1", "3_0", "3_1", "4_0"):
        t = f"de_conv{stage}"
        sd[f"{t}.conv.weight"] = _conv_w(p[t]["conv"]["kernel"])
        _bn(sd, f"{t}.bn", p[t]["bn"], s[t]["bn"])
    for head in ("pred", "weight_pred"):
        sd[f"{head}.weight"] = _conv_w(p[head]["kernel"])
        sd[f"{head}.bias"] = _t(p[head]["bias"])


def _mlp_points(sd, prefix, p, s):
    sd[f"{prefix}.0.weight"] = _conv_w(p["conv1"]["kernel"])
    _bn(sd, f"{prefix}.1", p["bn1"], s["bn1"])
    sd[f"{prefix}.3.weight"] = _conv_w(p["conv2"]["kernel"])
    _bn(sd, f"{prefix}.4", p["bn2"], s["bn2"])


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX SphericalFusion, SphericalFusionIterative or SphericalFusionSeg
    variables -> the port's state dict of the same model."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    iterative = "mlp_points1" in p
    _trunk(sd, p["trunk"], s["trunk"], "down1" if iterative else "down")
    for name in ("mlp_points1", "mlp_points2") if iterative else ("mlp_points",):
        _mlp_points(sd, name, p[name], s[name])
    return sd
