# Copyright 2026. Apache License 2.0.
"""Move V-Net weights between the JAX package and the port.

The JAX side is flax's variable tree ``{'params': ..., 'batch_stats':
...}`` as nested dicts of numpy arrays; the port's side is the
``state_dict`` of ``medicalseg_torch.models.VNet``. The mapping is the one
the JAX package's torch-alignment test uses
(``tests/test_vnet_torch_parity.py``):

* conv kernels: flax DHWIO [kd, kh, kw, Ci, Co] <-> torch OIDHW;
* ConvTranspose kernels: flipped spatially and stored [Ci, Co, kd, kh, kw]
  (flax correlates with the kernel as stored, torch's transposed conv
  with the mirrored one);
* BatchNorm ``scale``/``bias``/``mean``/``var`` <-> ``weight``/``bias``/
  ``running_mean``/``running_var`` (both keep the biased variance);
* PReLU ``alpha`` <-> ``alpha`` (absent with ``elu=True``).

Anything shaped like the parameters moves by the same map: gradients (a
flax gradient tree <-> the port's ``.grad``s) and the SGD momentum (an
``optax`` trace <-> ``momentum_buffer``), so that two trainers can start
from one state and be compared leaf by leaf after a few steps.
"""

from collections import OrderedDict
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_DOWN = (("down_tr32", "DownTransition_0", 1),
         ("down_tr64", "DownTransition_1", 2),
         ("down_tr128", "DownTransition_2", 3),
         ("down_tr256", "DownTransition_3", 2))
_UP = (("up_tr256", "UpTransition_0", 2),
       ("up_tr128", "UpTransition_1", 2),
       ("up_tr64", "UpTransition_2", 1),
       ("up_tr32", "UpTransition_3", 1))


def _layout() -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch module prefix, flax module path, kind) of every parameterised
    leaf module of VNet; kind is 'conv', 'deconv', 'bn' or 'prelu'."""
    def bn_act(prefix, path):
        yield prefix + ".bn1", path + ("BatchNorm3D_0",), "bn"
        yield prefix + ".relu1", path + ("Activation_0", "PReLU_0"), "prelu"

    def lu(prefix, path):
        yield prefix + ".conv1", path + ("Conv_0",), "conv"
        yield from bn_act(prefix, path)

    yield from lu("in_tr", ("InputTransition_0",))
    for tname, fname, n_convs in _DOWN:
        yield tname + ".down_conv", (fname, "Conv_0"), "conv"
        yield from bn_act(tname, (fname,))
        for i in range(n_convs):
            yield from lu("{}.ops.{}".format(tname, i),
                          (fname, "NConvs_0", "ConvBNAct_{}".format(i)))
        yield tname + ".relu2", (fname, "Activation_1", "PReLU_0"), "prelu"
    for tname, fname, n_convs in _UP:
        yield tname + ".up_conv", (fname, "ConvTranspose_0"), "deconv"
        yield from bn_act(tname, (fname,))
        for i in range(n_convs):
            yield from lu("{}.ops.{}".format(tname, i),
                          (fname, "NConvs_0", "ConvBNAct_{}".format(i)))
        yield tname + ".relu2", (fname, "Activation_1", "PReLU_0"), "prelu"
    yield from lu("out_tr", ("OutputTransition_0", "ConvBNAct_0"))
    yield "out_tr.conv2", ("OutputTransition_0", "Conv_0"), "conv"


def _get(tree, path):
    for key in path:
        if key not in tree:
            return None
        tree = tree[key]
    return tree


def _put(tree, path, key, value):
    for k in path:
        tree = tree.setdefault(k, {})
    tree[key] = value


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_from_flax(variables) -> "OrderedDict[str, torch.Tensor]":
    """The port VNet's ``state_dict`` from flax variables (nested dicts of
    arrays with 'params' and 'batch_stats'; without 'batch_stats', only
    the parameters' entries)."""
    params, stats = variables["params"], variables.get("batch_stats")
    sd = OrderedDict()
    for prefix, path, kind in _layout():
        p = _get(params, path)
        if p is None and kind == "prelu":
            continue  # elu=True: no PReLU parameters
        if p is None:
            raise KeyError("flax variables lack " + "/".join(path))
        if kind == "conv":
            sd[prefix + ".weight"] = _t(np.transpose(p["kernel"],
                                                     (4, 3, 0, 1, 2)))
            sd[prefix + ".bias"] = _t(p["bias"])
        elif kind == "deconv":
            k = np.asarray(p["kernel"])[::-1, ::-1, ::-1]
            sd[prefix + ".weight"] = _t(np.transpose(k, (3, 4, 0, 1, 2)))
            sd[prefix + ".bias"] = _t(p["bias"])
        elif kind == "bn":
            sd[prefix + ".weight"] = _t(p["scale"])
            sd[prefix + ".bias"] = _t(p["bias"])
            if stats is not None:
                s = _get(stats, path)
                sd[prefix + ".running_mean"] = _t(s["mean"])
                sd[prefix + ".running_var"] = _t(s["var"])
        else:
            sd[prefix + ".alpha"] = _t(p["alpha"])
    return sd


def flax_from_state_dict(state_dict) -> Dict[str, dict]:
    """The inverse of :func:`state_dict_from_flax`: flax variables
    ``{'params', 'batch_stats'}`` as nested dicts of float32 numpy
    arrays."""
    params, stats = {}, {}

    def a(key):
        return state_dict[key].detach().cpu().float().numpy()

    for prefix, path, kind in _layout():
        if kind == "prelu" and prefix + ".alpha" not in state_dict:
            continue
        if kind == "conv":
            _put(params, path, "kernel",
                 np.ascontiguousarray(np.transpose(a(prefix + ".weight"),
                                                   (2, 3, 4, 1, 0))))
            _put(params, path, "bias", a(prefix + ".bias"))
        elif kind == "deconv":
            k = np.transpose(a(prefix + ".weight"), (2, 3, 4, 0, 1))
            _put(params, path, "kernel",
                 np.ascontiguousarray(k[::-1, ::-1, ::-1]))
            _put(params, path, "bias", a(prefix + ".bias"))
        elif kind == "bn":
            _put(params, path, "scale", a(prefix + ".weight"))
            _put(params, path, "bias", a(prefix + ".bias"))
            if prefix + ".running_mean" in state_dict:
                _put(stats, path, "mean", a(prefix + ".running_mean"))
                _put(stats, path, "var", a(prefix + ".running_var"))
        else:
            _put(params, path, "alpha", a(prefix + ".alpha"))
    return {"params": params, "batch_stats": stats}


def params_from_flax(tree) -> "OrderedDict[str, torch.Tensor]":
    """A flax tree shaped like the parameters (the parameters themselves,
    their gradients, a momentum trace) as {port parameter name: tensor}."""
    return state_dict_from_flax({"params": tree})


def flax_from_params(named) -> dict:
    """The inverse of :func:`params_from_flax`: {port parameter name:
    tensor} (parameters only) as a flax-shaped tree of numpy arrays."""
    return flax_from_state_dict(dict(named))["params"]


def grads_to_flax(model) -> dict:
    """The model's ``.grad``s as a flax-shaped gradient tree."""
    return flax_from_params({n: p.grad for n, p in model.named_parameters()})


def grads_from_flax(model, grads):
    """Set the model's ``.grad``s from a flax gradient tree."""
    moved = params_from_flax(grads)
    for name, p in model.named_parameters():
        p.grad = moved[name].to(p.device, p.dtype)


def momentum_to_flax(model, optimizer) -> dict:
    """The SGD ``momentum_buffer`` of every parameter as an ``optax``
    trace tree (``optax.TraceState.trace``); zeros where the optimizer has
    not stepped yet."""
    named = {}
    for name, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        named[name] = torch.zeros_like(p) if buf is None else buf
    return flax_from_params(named)


def momentum_from_flax(model, optimizer, trace):
    """Load an ``optax`` trace tree into the SGD ``momentum_buffer``s."""
    moved = params_from_flax(trace)
    for name, p in model.named_parameters():
        optimizer.state[p]["momentum_buffer"] = moved[name].to(
            p.device, p.dtype).clone()
