"""Upstream checkpoint importer.

The port's counterpart of ``omnifusion_tpu/models/torch_import.py``. The
port's modules sit at the upstream checkpoint's names (models/convert.py),
so an upstream state dict (train_erp_depth.py:307 / test.py:108) needs no
renaming, only:

  - the ``state_dict`` wrapper unwrapped and the DataParallel ``module.``
    prefix stripped;
  - the Conv3d (O, I, k, k, 1) kernels (convert_conv,
    model/spherical_model.py:122-143) squeezed back to 2-D (O, I, k, k).
  - a BatchNorm's ``num_batches_tracked`` made 0-d where it has one element
    (a file written from numpy, as the JAX package's exporter writes it,
    holds shape (1,)).

An upstream checkpoint has no ``up_proj``: the port has that projection only
where the token width is not 512 (patch != 128). As in the JAX package, a
strict load then fails on the missing keys (eval, inference), and a partial
load (``merge_pretrained``, training) keeps the projection's own init.

Also: ``import_torchvision_resnet34`` (a plain torchvision resnet34 state
dict, 2-D convs, for pretrained-encoder initialization) and
``merge_pretrained``, the reference's load_partial_model (util.py:114-120).
"""

from __future__ import annotations

from typing import Mapping

import torch

_ENCODER_PREFIXES = ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.", "layer4.")


def _strip_module_prefix(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def _port_layout(key: str, w: torch.Tensor) -> torch.Tensor:
    """(O, I, kh, kw, 1) -> (O, I, kh, kw), a one-element count -> 0-d;
    anything else unchanged."""
    if key.endswith("num_batches_tracked"):
        return w.reshape(())
    if w.ndim == 5:
        if w.shape[-1] != 1:
            raise ValueError(f"a Conv3d kernel of depth {w.shape[-1]}: {tuple(w.shape)}")
        return w[..., 0]
    return w


def import_checkpoint(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """An upstream one-shot or iterative state dict, bare or wrapped in
    ``state_dict``, -> the port's state dict of the same model (the keys say
    which: ``down`` and ``mlp_points``, or ``down1``, ``mlp_points1`` and
    ``mlp_points2``)."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: _port_layout(k, torch.as_tensor(v)) for k, v in _strip_module_prefix(sd).items()}


def import_torchvision_resnet34(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A torchvision resnet34 state dict -> the encoder's entries of the
    port's state dict (its ``fc`` is dropped), for ``merge_pretrained``."""
    return {k: v for k, v in import_checkpoint(sd).items() if k.startswith(_ENCODER_PREFIXES)}


def merge_pretrained(
    state_dict: Mapping[str, torch.Tensor], pretrained: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Overlay imported (partial) entries onto ``state_dict``: entries of
    ``pretrained`` whose key ``state_dict`` has replace its own, the rest of
    ``state_dict`` is kept, and keys it lacks are ignored. Raises on a shape
    mismatch."""
    merged = dict(state_dict)
    for k, v in pretrained.items():
        if k in merged:
            if tuple(merged[k].shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {k}: {tuple(merged[k].shape)} vs "
                                 f"{tuple(v.shape)}")
            merged[k] = v.to(merged[k].dtype)
    return merged
