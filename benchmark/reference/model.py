"""Plain PyTorch reference of OmniFusion's trunk, shared by the model
kinds (``benchmark/reference/<model>.py``, found by a configuration's
``model``).

Functional: a model is a dict of named tensors (the upstream checkpoint's
names, which the program's modules also carry) and ``forward`` runs it.
The trunk (OmniFusion, Li et al., CVPR 2022; upstream
``model/spherical_model.py``):

ERP (B, H, W, 3) -> tangent patches (``tables.e2p``) -> ResNet-34 encoder
over the B*P patches, geometric point features added to layer1 -> one
token per patch from a 1x1 projection of layer4 -> pre-norm transformer
over the P tokens -> tokens added to layer4 -> decoder of five 2x
bilinear upsamples with encoder skips -> the heads (``heads``) -> the
merge to ERP (``tables.p2e``, ``merge_blend``). What differs between
kinds (the parameters' names around the trunk, the geometry input, the
heads' activation, the merge, the loss, the training targets) is the
kind's.

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
import importlib
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


def rounded(x: torch.Tensor, kind: str) -> torch.Tensor:
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
    return F.conv2d(rounded(x, kind), rounded(w, kind), b, stride, padding)




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


def kind(cfg):
    """The module of the configuration's model kind:
    ``benchmark/reference/<model>.py``."""
    return importlib.import_module(f"benchmark.reference.{cfg['model']}")


def trunk_specs(cfg, down: str, n_out: int) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the trunk, in the
    checkpoint's order: the encoder, the token projection ``down``, the
    transformer, the decoder, and the heads (``pred`` of ``n_out``
    outputs, ``weight_pred`` the confidence)."""
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
    s += _conv(down, c4, tc, 1, bias=True)
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
    s += _conv("pred", d[-1], n_out, 3, bias=True) + _conv("weight_pred", d[-1], 1, 3, bias=True)
    return s


def points_specs(cfg, name: str, fin: int) -> list[tuple[str, tuple, str]]:
    """The point embedding ``name`` of ``fin`` input channels."""
    hid, out = cfg["points_channels"]
    return (_conv(f"{name}.0", fin, hid, 1) + _bn(f"{name}.1", hid)
            + _conv(f"{name}.3", hid, out, 1) + _bn(f"{name}.4", out))


# --------------------------------------------------------------------------
# static inputs: tables and geometry


class Geometry:
    """The reference's tables and patch geometry of a configuration, as
    tensors on ``device``; on the meta device, empty tensors of their
    shapes (a merge of 4 quads a pixel). The kind adds what its forward
    reads (``<kind>.geometry``)."""

    def __init__(self, cfg, device):
        self.device = torch.device(device)
        erp, patch, fov, nrows = cfg["erp_size"], cfg["patch_size"], cfg["fov"], cfg["nrows"]
        n_in = cfg["n_patches"] * patch[0] * patch[1]
        self.e2p = self.blend(tables.e2p, (erp, patch, fov, nrows), (n_in, 4))
        self.p2e = self.blend(tables.p2e, (erp, patch, fov, nrows), (erp[0] * erp[1], 4, 4))
        kind(cfg).geometry(self, cfg)

    def tensor(self, make, shape, dtype=torch.float32) -> torch.Tensor:
        """The numpy array ``make()`` as a tensor (of ``shape`` on the meta
        device, where ``make`` is not called)."""
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        return torch.from_numpy(np.ascontiguousarray(make())).to(self.device, dtype)

    def blend(self, table, args, shape) -> tuple[torch.Tensor, torch.Tensor]:
        """(idx, w) of ``table(*args)`` (``tables.e2p`` or ``tables.p2e``)."""
        if self.device.type == "meta":
            return (self.tensor(None, shape, torch.long), self.tensor(None, shape))
        i, w = table(*args)
        return self.tensor(lambda: i, i.shape, torch.long), self.tensor(lambda: w, w.shape)


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


def patches(geom, cfg, rgb):
    """rgb (B, H, W, 3) -> the tangent patches (B*P, 3, h, w)."""
    b = rgb.shape[0]
    h, w = cfg["patch_size"]
    x = sample(rgb.reshape(b, -1, 3), *geom.e2p)  # (B, P*h*w, 3)
    return x.reshape(b, cfg["n_patches"], h, w, 3).permute(0, 1, 4, 2, 3).reshape(-1, 3, h, w)


def trunk(p, cfg, x, pf, b, train, prec, down):
    """x (B*P, 3, h, w), pf (B*P, 64, h/4, w/4) -> the decoder's output
    (B*P, 32, h, w); ``down`` names the token projection."""
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
    tok = conv(l4, p[f"{down}.weight"], p[f"{down}.bias"], kind=k).reshape(-1, emb)
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
    return conv_bn(p, "de_conv4_0.conv", "de_conv4_0.bn", up2x(y, (h, w)), train, k, 1, 1)


def heads(p, y, prec, relu: bool):
    """The decoder's output -> pred (ReLU'd where ``relu``) and the
    confidence (sigmoid), (B*P, n, h, w) and (B*P, 1, h, w)."""
    k = prec.convs
    pred = conv(y, p["pred.weight"], p["pred.bias"], 1, 1, k)
    pred = F.relu(pred) if relu else pred
    return pred, torch.sigmoid(conv(y, p["weight_pred.weight"], p["weight_pred.bias"], 1, 1, k))


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


def depth_loss(preds, batch):
    """The mean over the passes of each pass's BerHu against the batch's
    depth and mask."""
    return torch.stack([berhu(d, batch["depth"], batch["mask"]) for d in preds]).mean()


def depth_targets(cfg, traffic, gen, n, device) -> dict:
    """n depth maps in ``depth_range`` metres (a smooth field: seeded noise
    at 1/32 of the panorama, upsampled bilinearly) and their masks
    (``mask_share`` of the pixels valid, drawn per pixel), (n, H, W, 1)
    each, drawn from ``gen`` after the panoramas."""
    h, w = cfg["erp_size"]
    lo, hi = traffic["depth_range"]
    coarse = torch.rand(n, 1, h // 32, w // 32, generator=gen, device=device)
    depth = lo + (hi - lo) * F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    mask = (torch.rand(n, 1, h, w, generator=gen, device=device) < traffic["mask_share"]).float()
    return {"depth": depth.permute(0, 2, 3, 1), "mask": mask.permute(0, 2, 3, 1)}


def cosine_lr(base, t_0, t_mult, steps_per_epoch, step):
    """Cosine annealing with warm restarts, per epoch, eta_min 0."""
    t, t_i = step // steps_per_epoch, t_0
    while t >= t_i:
        t -= t_i
        t_i *= t_mult
    return base * (1.0 + math.cos(math.pi * t / t_i)) / 2.0
