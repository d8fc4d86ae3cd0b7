"""Weights in the reference's .pth layout.

`from_flax_params` turns the JAX package's `{'params': ...}` tree (numpy
arrays; the layout `rampvo_tpu.ckpt.torch_import.map_state_dict` produces)
into a state_dict for `models.vonet.VONet`: the exact inverse of that
mapping, with this package's own copy of the rules. The port's modules
carry the reference .pth key names, so a published checkpoint's
state_dict needs no renaming.
"""

from __future__ import annotations

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


def _head_rules(head: str):
    p, t = "patchify.encoder", "patchify/encoder"
    rules = {
        f"{p}.{head}.conv1": (f"{t}/{head}/conv1", "conv"),
        f"{p}.{head}.conv3": (f"{t}/{head}/conv3", "conv"),
    }
    for lyr in ("layer1", "layer3"):
        for b in (0, 1):
            base, tb = f"{p}.{head}.{lyr}.{b}", f"{t}/{head}/{lyr}_{b}"
            rules[f"{base}.conv1"] = (f"{tb}/conv1", "conv")
            rules[f"{base}.conv2"] = (f"{tb}/conv2", "conv")
            rules[f"{base}.downsample.0"] = (f"{tb}/downsample", "conv")
    return rules


def _rules() -> Dict[str, tuple]:
    """torch module path -> (flax path, kind), MultiScale VONet."""
    p, t = "patchify.encoder", "patchify/encoder"
    rules = {}
    for i in range(3):
        rules[f"{p}.ev_encoders.{i}.conv_1"] = (f"{t}/ev_encoders_{i}/conv_1", "conv")
        rules[f"{p}.im_encoders.{i}.conv_1"] = (f"{t}/im_encoders_{i}/conv_1", "conv")
        rules[f"{p}.ev_encoders.{i}.convlstm"] = (f"{t}/ev_encoders_{i}/convlstm", "lstm")
        rules[f"{p}.im_encoders.{i}.convlstm"] = (f"{t}/im_encoders_{i}/convlstm", "lstm")
        rules[f"{p}.super_state_ev_encoder.{i}.encoder"] = (
            f"{t}/super_state_ev_encoder_{i}", "ssconv")
        rules[f"{p}.super_state_im_encoders.{i}.encoder"] = (
            f"{t}/super_state_im_encoders_{i}", "ssconv")
    rules.update(_head_rules("fmap_encoder"))
    rules.update(_head_rules("imap_encoder"))
    u = "update"
    rules.update({
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
    })
    for seq_idx, name in ((1, "gru_res1"), (3, "gru_res2")):
        rules[f"{u}.gru.{seq_idx}.gate.0"] = (f"{u}/{name}/gate_fc", "linear")
        rules[f"{u}.gru.{seq_idx}.res.0"] = (f"{u}/{name}/res_fc1", "linear")
        rules[f"{u}.gru.{seq_idx}.res.2"] = (f"{u}/{name}/res_fc2", "linear")
    for agg in ("agg_kk", "agg_ij"):
        for fgh in "fgh":
            rules[f"{u}.{agg}.{fgh}"] = (f"{u}/{agg}/{fgh}", "linear")
    return rules


def _flax_to_torch(value: np.ndarray) -> np.ndarray:
    if value.ndim == 4:                      # conv HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    if value.ndim == 2:                      # linear / LSTM [I, O] -> [O, I]
        return np.transpose(value)
    return value


def from_flax_params(variables) -> Dict[str, torch.Tensor]:
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
    for base, (tgt, kind) in _rules().items():
        if kind == "ssconv":
            leaves = {"weight": f"{tgt}_kernel", "bias": f"{tgt}_bias"}
        else:
            leaves = {k: f"{tgt}/{v}" for k, v in _LEAF[kind].items()}
        for leaf, path in leaves.items():
            val = get(path)
            if val is None:
                continue
            arr = _flax_to_torch(np.asarray(val, np.float32))
            out[f"{base}.{leaf}"] = torch.tensor(arr)
    return out

