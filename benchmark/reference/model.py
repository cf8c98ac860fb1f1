"""Plain PyTorch reference of OmniFusion's one-shot and iterative models.

Functional: a model is a dict of named tensors (the upstream checkpoint's
names, which the program's modules also carry) and ``forward`` runs it.
Architecture (OmniFusion, Li et al., CVPR 2022; upstream
``model/spherical_model.py`` and ``spherical_model_iterative.py``):

ERP (B, H, W, 3) -> tangent patches (``tables.e2p``) -> ResNet-34 encoder
over the B*P patches, geometric point features added to layer1 -> one
token per patch from a 1x1 projection of layer4 -> pre-norm transformer
over the P tokens -> tokens added to layer4 -> decoder of five 2x
bilinear upsamples with encoder skips -> depth (ReLU) and confidence
(sigmoid) heads -> confidence-weighted merge to ERP (``tables.p2e``).
The iterative model runs the same trunk again on point features of the
previous depth, projected to quarter-resolution patches; its merges are
unweighted.

``Precision`` says how the convolutions and the merge's source are
computed (the transformer, as in the program's recipes, runs in f32): "f32" (the reference; TF32 is switched off by the
caller), "tf32" (operands rounded to TF32's 10-bit mantissa), "bf16"
(operands rounded to bf16), "fp8" (operands rounded to float8 e4m3 with a
per-tensor scale), products summed in f32. BatchNorm,
LayerNorm, softmax and the merge's sums run in f32.

Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import tables

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Precision:
    convs: str = "f32"  # the convolutions: f32, tf32, bf16 or fp8
    merge: str = "f32"  # the merge's source: f32, f16 or fp8


def _round(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x rounded to ``kind`` and back to f32 (for "tf32", its 10-bit
    mantissa, round to nearest even, gradients passed straight through)."""
    if kind == "f32":
        return x
    if kind == "tf32":
        bits = x.detach().contiguous().view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -8192
        return x + (bits.view(torch.float32) - x).detach()
    if kind in ("bf16", "f16"):
        return x.to(torch.bfloat16 if kind == "bf16" else torch.float16).float()
    if kind == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {kind!r}")


def conv(x, w, b=None, stride=1, padding=0, kind="f32"):
    return F.conv2d(_round(x, kind), _round(w, kind), b, stride, padding)




# --------------------------------------------------------------------------
# parameters


def _bn(name, c):
    return [(f"{name}.weight", (c,), "bn_w"), (f"{name}.bias", (c,), "bn_b"),
            (f"{name}.running_mean", (c,), "bn_rm"), (f"{name}.running_var", (c,), "bn_rv"),
            (f"{name}.num_batches_tracked", (), "bn_n")]


def _conv(name, cin, cout, k, bias=False):
    out = [(f"{name}.weight", (cout, cin, k, k), "conv")]
    return out + ([(f"{name}.bias", (cout,), "bias")] if bias else [])


def _ln(name, c):
    return [(f"{name}.weight", (c,), "ln_w"), (f"{name}.bias", (c,), "ln_b")]


def token_size(cfg) -> tuple[int, int, int]:
    """(emb, hh, ww): the token width and layer4's side."""
    hh, ww = -(-cfg["patch_size"][0] // 32), -(-cfg["patch_size"][1] // 32)
    return cfg["token_channels"] * hh * ww, hh, ww


def points_names(cfg) -> list[str]:
    return ["mlp_points"] if cfg["model"] == "oneshot" else ["mlp_points1", "mlp_points2"]


def down_name(cfg) -> str:
    return "down" if cfg["model"] == "oneshot" else "down1"


def param_specs(cfg) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the model's state."""
    s = []
    stages = cfg["encoder_stages"]
    s += _conv("conv1", 3, 64, 7) + _bn("bn1", 64)
    cin = 64
    for i, (c, blocks, stride) in enumerate(stages, start=1):
        for j in range(blocks):
            p = f"layer{i}.{j}"
            first_in = cin if j == 0 else c
            s += _conv(f"{p}.conv1", first_in, c, 3) + _bn(f"{p}.bn1", c)
            s += _conv(f"{p}.conv2", c, c, 3) + _bn(f"{p}.bn2", c)
            if j == 0 and (stride != 1 or first_in != c):
                s += _conv(f"{p}.downsample.0", first_in, c, 1) + _bn(f"{p}.downsample.1", c)
        cin = c
    c1, c2, c3, c4 = (st[0] for st in stages)
    emb, _, _ = token_size(cfg)
    tc = cfg["token_channels"]
    s += _conv(down_name(cfg), c4, tc, 1, bias=True)
    s += [("transformer.pos_emb", (1, cfg["n_patches"], emb), "pos_emb")]
    hidden = int(emb * cfg["mlp_ratio"])
    for i in range(cfg["transformer_depth"]):
        p = f"transformer.layer.{i}"
        s += _ln(f"{p}.norm1", emb)
        s += [(f"{p}.attn.q.weight", (emb, emb), "linear"),
              (f"{p}.attn.kv.weight", (2 * emb, emb), "linear"),
              (f"{p}.attn.proj.weight", (emb, emb), "linear"), (f"{p}.attn.proj.bias", (emb,), "bias")]
        s += _ln(f"{p}.norm2", emb)
        s += [(f"{p}.mlp.fc1.weight", (hidden, emb), "linear"), (f"{p}.mlp.fc1.bias", (hidden,), "bias"),
              (f"{p}.mlp.fc2.weight", (emb, hidden), "linear"), (f"{p}.mlp.fc2.bias", (emb,), "bias")]
    s += _ln("transformer.encoder_norm", emb)
    if emb != c4:
        s += _conv("up_proj", tc, c4, 1, bias=True)
    d = cfg["decoder_channels"]  # de_conv0_0 .. de_conv4_0
    ins = [c4, d[0] + c3, d[1], d[2] + c2, d[3], d[4] + c1, d[5], d[6] + 64, d[7]]
    names = ["de_conv0_0", "de_conv0_1", "de_conv1_0", "de_conv1_1", "de_conv2_0",
             "de_conv2_1", "de_conv3_0", "de_conv3_1", "de_conv4_0"]
    for n, ci, co in zip(names, ins, d):
        s += _conv(f"{n}.conv", ci, co, 3) + _bn(f"{n}.bn", co)
    s += _conv("pred", d[-1], 1, 3, bias=True) + _conv("weight_pred", d[-1], 1, 3, bias=True)
    hid, out = cfg["points_channels"]
    for n in points_names(cfg):
        fin = 5 if cfg["model"] == "oneshot" else 3
        s += _conv(f"{n}.0", fin, hid, 1) + _bn(f"{n}.1", hid)
        s += _conv(f"{n}.3", hid, out, 1) + _bn(f"{n}.4", out)
    return s


# --------------------------------------------------------------------------
# static inputs: tables and geometry


class Geometry:
    """The reference's tables and patch geometry of a configuration, as
    tensors on ``device``."""

    def __init__(self, cfg, device):
        erp, patch, fov, nrows = cfg["erp_size"], cfg["patch_size"], cfg["fov"], cfg["nrows"]
        t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
        i, w = tables.e2p(erp, patch, fov, nrows)
        self.e2p = (t(i, torch.long), t(w))
        i, w = tables.p2e(erp, patch, fov, nrows)
        self.p2e = (t(i, torch.long), t(w))
        quarter = (patch[0] // 4, patch[1] // 4)
        c = tables.centers_normalized(nrows).astype(np.float32)
        geo = np.concatenate([c, np.ones_like(c[:, :1]), c], -1)[:, :, None, None]
        self.geo = t(np.broadcast_to(geo, (*geo.shape[:2], *quarter)))  # (P, 5, h/4, w/4)
        if cfg["model"] == "iterative":
            i, w = tables.e2p(erp, quarter, fov, nrows)
            self.e2p_quarter = (t(i, torch.long), t(w))
            self.xyz = t(tables.unit_sphere(quarter, fov, nrows))  # (P, 3, h/4, w/4)


def sample(src, idx, w):
    """src (B, N_in, C) -> (B, N_out, C): the weighted corners of e2p."""
    out = 0.0
    for q in range(4):
        out = out + src[:, idx[:, q]] * w[:, q, None]
    return out


def merge_blend(src, idx, w):
    """src (B, C, N_in) -> (B, C, N_out): p2e's weighted quads."""
    out = 0.0
    for k in range(idx.shape[1]):
        for q in range(4):
            out = out + src[..., idx[:, k, q]] * w[:, k, q]
    return out


# --------------------------------------------------------------------------
# layers


class RecordStats(dict):
    """Train mode that also keeps each BatchNorm's batch mean and unbiased
    variance, by name."""

    def __bool__(self):
        return True


def batch_norm(p, name, x, train):
    g, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        if isinstance(train, RecordStats):
            train[name] = (mean, x.var((0, 2, 3), unbiased=True))
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    scale = g / torch.sqrt(var + BN_EPS)
    return x * scale[:, None, None] + (b - mean * scale)[:, None, None]


def conv_bn(p, name, bn, x, train, kind, stride=1, padding=0, relu=True):
    y = batch_norm(p, bn, conv(x, p[f"{name}.weight"], None, stride, padding, kind), train)
    return F.relu(y) if relu else y


def basic_block(p, name, x, stride, train, kind):
    out = conv_bn(p, f"{name}.conv1", f"{name}.bn1", x, train, kind, stride, 1)
    out = conv_bn(p, f"{name}.conv2", f"{name}.bn2", out, train, kind, 1, 1, relu=False)
    if f"{name}.downsample.0.weight" in p:
        x = conv_bn(p, f"{name}.downsample.0", f"{name}.downsample.1", x, train, kind, stride,
                    0, relu=False)
    return F.relu(out + x)


def points(p, name, x, train, kind):
    x = conv_bn(p, f"{name}.0", f"{name}.1", x, train, kind)
    return conv_bn(p, f"{name}.3", f"{name}.4", x, train, kind)


def layer_norm(p, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def transformer(p, cfg, tok):
    heads = cfg["num_heads"]
    x = tok + p["transformer.pos_emb"]
    for i in range(cfg["transformer_depth"]):
        pre = f"transformer.layer.{i}"
        y = layer_norm(p, f"{pre}.norm1", x, 1e-5)
        b, n, c = y.shape
        d = c // heads
        q = F.linear(y, p[f"{pre}.attn.q.weight"]).reshape(b, n, heads, d).transpose(1, 2)
        kv = F.linear(y, p[f"{pre}.attn.kv.weight"]).reshape(b, n, 2, heads, d)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        a = torch.softmax(q @ k.transpose(-2, -1) * d ** -0.5, -1)
        y = (a @ v).transpose(1, 2).reshape(b, n, c)
        x = x + F.linear(y, p[f"{pre}.attn.proj.weight"], p[f"{pre}.attn.proj.bias"])
        y = layer_norm(p, f"{pre}.norm2", x, 1e-5)
        y = F.gelu(F.linear(y, p[f"{pre}.mlp.fc1.weight"], p[f"{pre}.mlp.fc1.bias"]))
        x = x + F.linear(y, p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"])
    return layer_norm(p, "transformer.encoder_norm", x, 1e-6)


def up2x(x, size=None):
    return F.interpolate(x, size=size or tuple(2 * s for s in x.shape[-2:]), mode="bilinear",
                         align_corners=False)


def trunk(p, cfg, x, pf, b, train, prec):
    """x (B*P, 3, h, w), pf (B*P, 64, h/4, w/4) -> pred, conf (B*P, 1, h, w)."""
    k = prec.convs
    h, w = x.shape[-2:]
    c1 = conv_bn(p, "conv1", "bn1", x, train, k, 2, 3)
    y = F.max_pool2d(c1, 3, 2, 1)
    feats = []
    for i, (_, blocks, stride) in enumerate(cfg["encoder_stages"], start=1):
        for j in range(blocks):
            y = basic_block(p, f"layer{i}.{j}", y, stride if j == 0 else 1, train, k)
        if i == 1:
            y = y + pf
        feats.append(y)
    l1, l2, l3, l4 = feats
    emb, hh, ww = token_size(cfg)
    dn = down_name(cfg)
    tok = conv(l4, p[f"{dn}.weight"], p[f"{dn}.bias"], kind=k).reshape(-1, emb)
    tok = transformer(p, cfg, tok.reshape(b, cfg["n_patches"], emb))
    tok = tok.reshape(-1, emb)
    if emb == l4.shape[1]:
        l4 = l4 + tok[:, :, None, None]
    else:
        l4 = l4 + conv(tok.reshape(-1, cfg["token_channels"], hh, ww), p["up_proj.weight"],
                       p["up_proj.bias"], kind=k)

    def stage(y, skip, n0, n1):
        y = conv_bn(p, f"{n0}.conv", f"{n0}.bn", up2x(y), train, k, 1, 1)
        return conv_bn(p, f"{n1}.conv", f"{n1}.bn", torch.cat([y, skip], 1), train, k, 1, 1)

    y = stage(l4, l3, "de_conv0_0", "de_conv0_1")
    y = stage(y, l2, "de_conv1_0", "de_conv1_1")
    y = stage(y, l1, "de_conv2_0", "de_conv2_1")
    y = stage(y, c1, "de_conv3_0", "de_conv3_1")
    y = conv_bn(p, "de_conv4_0.conv", "de_conv4_0.bn", up2x(y, (h, w)), train, k, 1, 1)
    pred = F.relu(conv(y, p["pred.weight"], p["pred.bias"], 1, 1, k))
    conf = torch.sigmoid(conv(y, p["weight_pred.weight"], p["weight_pred.bias"], 1, 1, k))
    return pred, conf


def merge(geom, cfg, pred, conf, b, prec, weighted):
    """(B*P, 1, h, w) heads -> (B, H, W, 1) depth."""
    H, W = cfg["erp_size"]
    idx, w = geom.p2e
    pred, conf = pred.reshape(b, -1), conf.reshape(b, -1)
    if not weighted:
        return merge_blend(_round(pred[:, None], prec.merge), idx, w).reshape(b, H, W, 1)
    src = _round(torch.stack([pred * conf, conf], 1), prec.merge)
    num, den = merge_blend(src, idx, w).unbind(1)
    den = den + 1e-8 * (den <= 1e-8).to(den.dtype)
    return (num / den).reshape(b, H, W, 1)


def forward(p, cfg, geom, rgb, prec=Precision(), train=False):
    """rgb (B, H, W, 3) -> the list of each pass's depth (B, H, W, 1)."""
    b = rgb.shape[0]
    P = cfg["n_patches"]
    h, w = cfg["patch_size"]
    hq, wq = h // 4, w // 4
    x = sample(rgb.reshape(b, -1, 3), *geom.e2p)  # (B, P*h*w, 3)
    x = x.reshape(b, P, h, w, 3).permute(0, 1, 4, 2, 3).reshape(b * P, 3, h, w)
    if cfg["model"] == "oneshot":
        pf = points(p, "mlp_points", geom.geo, train, prec.convs)
        pf = pf.expand(b, *pf.shape).reshape(b * P, *pf.shape[1:])
        return [merge(geom, cfg, *trunk(p, cfg, x, pf, b, train, prec), b, prec, True)]
    pf = points(p, "mlp_points1", geom.xyz, train, prec.convs)
    pf = pf.expand(b, *pf.shape).reshape(b * P, *pf.shape[1:])
    preds = [merge(geom, cfg, *trunk(p, cfg, x, pf, b, train, prec), b, prec, False)]
    for _ in range(cfg["num_iters"] - 1):
        d = sample(preds[-1].reshape(b, -1, 1), *geom.e2p_quarter)  # (B, P*hq*wq, 1)
        pts = geom.xyz[None] * d.reshape(b, P, 1, hq, wq)
        pf = points(p, "mlp_points2", pts.reshape(b * P, 3, hq, wq), train, prec.convs)
        preds.append(merge(geom, cfg, *trunk(p, cfg, x, pf, b, train, prec), b, prec, False))
    return preds


def berhu(pred, gt, mask):
    """Adaptive reverse-Huber loss, per-sample masked mean; the cutoff
    c = max |gt - pred| / 5 over all pixels, held constant."""
    b = pred.shape[0]
    diff = (gt - pred).reshape(b, -1)
    a = diff.abs()
    c = a.max().detach() / 5.0
    loss = torch.where(a <= c, a, (diff * diff + c * c) / torch.clamp(2.0 * c, min=1e-12))
    m = mask.reshape(b, -1).float()
    return ((loss * m).sum(1) / torch.clamp(m.sum(1), min=1.0)).mean()


def cosine_lr(base, t_0, t_mult, steps_per_epoch, step):
    """Cosine annealing with warm restarts, per epoch, eta_min 0."""
    t, t_i = step // steps_per_epoch, t_0
    while t >= t_i:
        t -= t_i
        t_i *= t_mult
    return base * (1.0 + math.cos(math.pi * t / t_i)) / 2.0
