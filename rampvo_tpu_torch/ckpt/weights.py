"""Weights in the reference's .pth layout.

`load_pth` reads a reference checkpoint (a published `RAMPVO_*.pth` or a
train.py checkpoint dict) into a state_dict for `models.vonet.VONet`, with
the reference loader's key hygiene (ramp/Ramp_vo.py:103-118): a wrapping
{"model_state_dict": ...} is opened, "module." prefixes are stripped,
"update.lmbda" is dropped, and so are the MultiScale heads' layer2/conv2,
which the reference creates but never runs. The port's modules carry the
reference key names, so nothing else is renamed.

`from_flax_params` turns the JAX package's `{'params': ...}` tree (numpy
arrays; the layout `rampvo_tpu.ckpt.torch_import.map_state_dict`
produces) into the same state_dict: the exact inverse of that mapping,
with this package's own copy of the rules.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

# how each torch leaf maps to a flax leaf, per module kind
_LEAF = {
    "conv": {"weight": "kernel", "bias": "bias"},
    "linear": {"weight": "kernel", "bias": "bias"},
    "ln": {"weight": "scale", "bias": "bias"},
    "lstm": {"weight_ih_l0": "weight_ih", "weight_hh_l0": "weight_hh",
             "bias_ih_l0": "bias_ih", "bias_hh_l0": "bias_hh"},
}

# modules the reference's MultiScale heads create but never run
_UNUSED_MULTISCALE = re.compile(
    r"patchify\.encoder\.(fmap|imap)_encoder\.(layer2\.|conv2\.)")


def _head_rules(head: str, multiscale: bool):
    """The MultiScale pyramid head runs conv1, layer1, layer3, conv3; the
    SingleScale BasicEncoder4 conv1, layer1, layer2, conv2."""
    p, t = "patchify.encoder", "patchify/encoder"
    layers = ("layer1", "layer3") if multiscale else ("layer1", "layer2")
    out_conv = "conv3" if multiscale else "conv2"
    rules = {
        f"{p}.{head}.conv1": (f"{t}/{head}/conv1", "conv"),
        f"{p}.{head}.{out_conv}": (f"{t}/{head}/{out_conv}", "conv"),
    }
    for lyr in layers:
        for b in (0, 1):
            base, tb = f"{p}.{head}.{lyr}.{b}", f"{t}/{head}/{lyr}_{b}"
            rules[f"{base}.conv1"] = (f"{tb}/conv1", "conv")
            rules[f"{base}.conv2"] = (f"{tb}/conv2", "conv")
            rules[f"{base}.downsample.0"] = (f"{tb}/downsample", "conv")
    return rules


def _encoder_rules(input_mode: str) -> Dict[str, tuple]:
    p, t = "patchify.encoder", "patchify/encoder"
    rules = {}
    if input_mode == "SingleScale":
        rules[f"{p}.events_convlstm"] = (f"{t}/events_convlstm", "lstm")
        rules[f"{p}.image_convlstm"] = (f"{t}/image_convlstm", "lstm")
        rules[f"{p}.superstate_encoder"] = (f"{t}/superstate_encoder",
                                            "ssconv")
    elif input_mode == "MultiScale":
        for i in range(3):
            for enc in ("ev_encoders", "im_encoders"):
                rules[f"{p}.{enc}.{i}.conv_1"] = (f"{t}/{enc}_{i}/conv_1",
                                                  "conv")
                rules[f"{p}.{enc}.{i}.convlstm"] = (f"{t}/{enc}_{i}/convlstm",
                                                    "lstm")
            rules[f"{p}.super_state_ev_encoder.{i}.encoder"] = (
                f"{t}/super_state_ev_encoder_{i}", "ssconv")
            rules[f"{p}.super_state_im_encoders.{i}.encoder"] = (
                f"{t}/super_state_im_encoders_{i}", "ssconv")
    else:
        raise ValueError(f"Invalid input mode: {input_mode}")
    multiscale = input_mode == "MultiScale"
    rules.update(_head_rules("fmap_encoder", multiscale))
    rules.update(_head_rules("imap_encoder", multiscale))
    return rules


def _update_rules() -> Dict[str, tuple]:
    u = "update"
    rules = {
        f"{u}.c1.0": (f"{u}/c1_fc1", "linear"),
        f"{u}.c1.2": (f"{u}/c1_fc2", "linear"),
        f"{u}.c2.0": (f"{u}/c2_fc1", "linear"),
        f"{u}.c2.2": (f"{u}/c2_fc2", "linear"),
        f"{u}.norm": (f"{u}/norm", "ln"),
        f"{u}.corr.0": (f"{u}/corr_fc1", "linear"),
        f"{u}.corr.2": (f"{u}/corr_fc2", "linear"),
        f"{u}.corr.3": (f"{u}/corr_ln", "ln"),
        f"{u}.corr.5": (f"{u}/corr_fc3", "linear"),
        f"{u}.gru.0": (f"{u}/gru_ln1", "ln"),
        f"{u}.gru.2": (f"{u}/gru_ln2", "ln"),
        f"{u}.d.1": (f"{u}/d_fc", "linear"),
        f"{u}.w.1": (f"{u}/w_fc", "linear"),
    }
    for seq_idx, name in ((1, "gru_res1"), (3, "gru_res2")):
        rules[f"{u}.gru.{seq_idx}.gate.0"] = (f"{u}/{name}/gate_fc", "linear")
        rules[f"{u}.gru.{seq_idx}.res.0"] = (f"{u}/{name}/res_fc1", "linear")
        rules[f"{u}.gru.{seq_idx}.res.2"] = (f"{u}/{name}/res_fc2", "linear")
    for agg in ("agg_kk", "agg_ij"):
        for fgh in "fgh":
            rules[f"{u}.{agg}.{fgh}"] = (f"{u}/{agg}/{fgh}", "linear")
    return rules


def _rules(input_mode: str) -> Dict[str, tuple]:
    """torch module path -> (flax path, kind) of a VONet."""
    return {**_encoder_rules(input_mode), **_update_rules()}


def _leaves(tgt: str, kind: str) -> Dict[str, str]:
    """torch leaf -> flax path of one module."""
    if kind == "ssconv":
        return {"weight": f"{tgt}_kernel", "bias": f"{tgt}_bias"}
    return {k: f"{tgt}/{v}" for k, v in _LEAF[kind].items()}


def _flax_to_torch(value: np.ndarray) -> np.ndarray:
    if value.ndim == 4:                      # conv HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    if value.ndim == 2:                      # linear / LSTM [I, O] -> [O, I]
        return np.transpose(value)
    return value


def from_flax_params(variables, input_mode: str = "MultiScale"
                     ) -> Dict[str, torch.Tensor]:
    """{'params': tree} of numpy arrays -> the port's VONet state_dict."""
    tree = variables["params"] if "params" in variables else variables

    def get(path: str):
        node = tree
        for part in path.split("/"):
            if part not in node:
                return None
            node = node[part]
        return node

    out: Dict[str, torch.Tensor] = {}
    for base, (tgt, kind) in _rules(input_mode).items():
        for leaf, path in _leaves(tgt, kind).items():
            val = get(path)
            if val is None:
                continue
            arr = _flax_to_torch(np.asarray(val, np.float32))
            out[f"{base}.{leaf}"] = torch.tensor(arr)
    return out


def conv_lstm_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX `ConvLSTMCell`'s {'params': {'Gates': {kernel, bias}}}
    (numpy arrays) -> the port's `models.ConvLSTMCell` state_dict."""
    tree = variables["params"] if "params" in variables else variables
    g = tree["Gates"]
    return {f"Gates.{leaf}": torch.tensor(_flax_to_torch(
        np.asarray(g[name], np.float32)))
        for leaf, name in _LEAF["conv"].items()}


def map_state_dict(state_dict, input_mode: str):
    """The reference loader's key hygiene on a reference state_dict (its
    values tensors or arrays): "module." prefixes dropped, `update.lmbda`
    and the MultiScale encoder's unused blocks skipped, every other key
    checked against the port's VONet for `input_mode` (port of
    rampvo_tpu/ckpt/torch_import.py::map_state_dict, which maps the same
    keys into flax variables). Returns (the port's float32 state_dict,
    skipped keys); raises on a key that no rule maps."""
    multiscale = input_mode == "MultiScale"
    rules = _rules(input_mode)
    out: Dict[str, torch.Tensor] = {}
    skipped = []
    for key, val in state_dict.items():
        key = key.replace("module.", "")
        if key == "update.lmbda" or (multiscale
                                     and _UNUSED_MULTISCALE.match(key)):
            skipped.append(key)
            continue
        base, _, leaf = key.rpartition(".")
        if base not in rules or leaf not in _leaves(*rules[base]):
            raise KeyError(f"unmapped checkpoint key: {key}")
        out[key] = (val.detach().cpu().float()
                    if isinstance(val, torch.Tensor)
                    else torch.as_tensor(np.asarray(val, np.float32)))
    return out, skipped


def load_pth(path_or_dict, input_mode: str) -> Dict[str, torch.Tensor]:
    """A reference .pth (file path or already loaded dict) -> the port's
    float32 VONet state_dict for `input_mode`, through the reference
    loader's key hygiene (`map_state_dict`). Raises on a key that no rule
    maps."""
    if isinstance(path_or_dict, dict):
        ckpt = path_or_dict
    else:
        # tensors, containers and numbers only: no code runs on load
        ckpt = torch.load(path_or_dict, map_location="cpu", weights_only=True)
    if "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return map_state_dict(ckpt, input_mode)[0]
