# Copyright 2026. Apache License 2.0.
"""YAML config system.

Counterpart of ``medicalseg_tpu/cvlibs/config.py``: the same YAML schema,
with recursive ``_base_:`` inheritance, deep merge, the ``_inherited_:
False`` opt-out and the overrides for lr / batch_size / iters, while its
properties produce PyTorch objects:

* ``.model``        -> the port's ``nn.Module``;
* ``.lr_scheduler`` -> a schedule: a function of the number of updates
  done so far (0 for the first) that returns the learning rate, as an
  optax schedule is;
* ``.optimizer``    -> a ``torch.optim.Optimizer`` over the model's
  parameters, with coupled L2 ``weight_decay`` on every parameter (adamw:
  decoupled); ``core.state`` sets its learning rate from the schedule
  before every update. :func:`capturable` turns it into the form a CUDA
  graph of the train step can replay (the learning rate a 0-d tensor on
  the parameters' device);
* ``.loss``         -> {'types': [loss callables], 'coef': [...]};
* ``.train_dataset`` / ``.val_dataset`` -> the port's datasets, their
  ``dataset_root`` / ``result_dir`` joined to ``data_root``.

``model.num_classes`` may be left out and is then taken from the datasets;
``model.pretrained`` names a ``model.msgpack`` (either package's) loaded
key by key, shape-checked.
"""

import codecs
import math
import os
import warnings
from typing import Any, Callable, Dict

import torch
import yaml

from ..utils import logger
from ..utils.checkpoint import load_pretrained_model
from . import manager

DTYPES = {"float32": torch.float32, "fp32": torch.float32,
          "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}

# model keys that choose between TPU implementations of the same math
# (Pallas vs XLA convs, layouts); the port has one implementation
TPU_ONLY_KEYS = ("head_conv", "mid_conv", "updown_conv", "layout_policy",
                 "head_1x1")


def _update_dic(dic, base_dic):
    """Deep-merge ``dic`` onto ``base_dic``; ``_inherited_: False`` cuts
    inheritance."""
    base_dic = base_dic.copy()
    dic = dic.copy()
    if dic.get("_inherited_", True) is False:
        dic.pop("_inherited_")
        return dic
    for key, val in dic.items():
        if isinstance(val, dict) and isinstance(base_dic.get(key), dict):
            base_dic[key] = _update_dic(val, base_dic[key])
        else:
            base_dic[key] = val
    return base_dic


def parse_from_yaml(path: str) -> Dict[str, Any]:
    with codecs.open(path, "r", "utf-8") as file:
        dic = yaml.load(file, Loader=yaml.FullLoader)
    if "_base_" in dic:
        base_path = os.path.join(os.path.dirname(path), dic.pop("_base_"))
        dic = _update_dic(dic, parse_from_yaml(base_path))
    return dic


def build_model(model_cfg: Dict[str, Any], dtype=None,
                generator: torch.Generator = None) -> torch.nn.Module:
    """The registered model named by ``model_cfg['type']``. ``dtype``
    (a torch dtype) overrides the section's ``dtype``; a ``dtype`` string
    maps to its torch dtype. ``generator`` seeds the initial weights, and
    ``pretrained`` (a ``model.msgpack`` or its directory) overwrites those
    it holds at the same shapes."""
    cfg = dict(model_cfg)
    kind = cfg.pop("type")
    pretrained = cfg.pop("pretrained", None)
    for key in TPU_ONLY_KEYS:
        cfg.pop(key, None)
    if dtype is not None:
        cfg["dtype"] = dtype
    elif isinstance(cfg.get("dtype"), str):
        cfg["dtype"] = DTYPES[cfg["dtype"]]
    model = manager.MODELS[kind](generator=generator, **cfg)
    if pretrained is not None:
        load_pretrained_model(model, pretrained)
    return model


def polynomial_decay(learning_rate, decay_steps, end_lr=0.0, power=0.9):
    """(lr - end) * (1 - min(step, decay_steps) / decay_steps) ** power +
    end (``optax.polynomial_schedule``)."""
    def schedule(step):
        frac = 1.0 - min(max(step, 0), decay_steps) / decay_steps
        return (learning_rate - end_lr) * frac ** power + end_lr
    return schedule


def piecewise_decay(boundaries, values):
    """values[number of boundaries that step has reached]."""
    def schedule(step):
        return values[sum(step >= b for b in boundaries)]
    return schedule


def step_decay(learning_rate, step_size, gamma=0.1):
    def schedule(step):
        return learning_rate * gamma ** (step // step_size)
    return schedule


def cosine_annealing_decay(learning_rate, decay_steps, eta_min=0.0):
    """``optax.cosine_decay_schedule`` with alpha = eta_min / lr."""
    alpha = eta_min / max(learning_rate, 1e-12)

    def schedule(step):
        cos = 0.5 * (1 + math.cos(math.pi * min(max(step, 0), decay_steps) /
                                  decay_steps))
        return learning_rate * ((1 - alpha) * cos + alpha)
    return schedule


def _lr_tensor(lr, params):
    """``lr`` as a 0-d float32 tensor on the device of ``params``."""
    device = params[0].device if params else torch.device("cpu")
    return torch.tensor(float(lr), dtype=torch.float32, device=device)


class SGD(torch.optim.Optimizer):
    """``torch.optim.SGD`` (momentum without dampening, coupled L2
    ``weight_decay``, Nesterov) in a form a CUDA graph can replay: the
    learning rate is a 0-d tensor on the parameters' device, read by the
    update on the device (``torch.optim.SGD`` turns a tensor learning rate
    into a host scalar, a sync a graph cannot capture), and the momentum
    buffers exist from the start (zeros, which is what the first update of
    ``torch.optim.SGD`` and ``optax.sgd`` starts from), so no update
    allocates. Set the learning rate with :func:`set_lr`, outside the
    graph."""

    def __init__(self, params, lr, momentum=0.0, weight_decay=0.0,
                 nesterov=False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov))
        for group in self.param_groups:
            group["lr"] = _lr_tensor(group["lr"], group["params"])
            if group["momentum"]:
                for p in group["params"]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            if group["momentum"]:
                bufs = [self.state[p]["momentum_buffer"] for p in params]
                torch._foreach_mul_(bufs, group["momentum"])
                torch._foreach_add_(bufs, grads)
                grads = (torch._foreach_add(grads, bufs,
                                            alpha=group["momentum"])
                         if group["nesterov"] else bufs)
            torch._foreach_sub_(params, torch._foreach_mul(grads,
                                                           group["lr"]))


class RMSProp(torch.optim.Optimizer):
    """RMSProp as ``optax.rmsprop`` computes it: nu = rho * nu + (1 - rho)
    * g^2, update = lr * g / sqrt(nu + eps) with eps *inside* the root
    (``torch.optim.RMSprop`` adds it outside), then the momentum trace of
    the updates already scaled by the learning rate. ``weight_decay`` is
    coupled L2, added to the gradient first. The learning rate may be a
    float or a 0-d tensor on the parameters' device (:func:`capturable`);
    the slots exist from the start, so no update allocates."""

    def __init__(self, params, lr, rho=0.95, eps=1e-6, momentum=0.0,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps,
                                      momentum=momentum,
                                      weight_decay=weight_decay))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["nu"] = torch.zeros_like(p)
                self.state[p]["momentum_buffer"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                state["nu"].mul_(group["rho"]).addcmul_(
                    g, g, value=1 - group["rho"])
                upd = g * torch.rsqrt(state["nu"] + group["eps"])
                upd.mul_(group["lr"])
                if group["momentum"]:
                    upd = state["momentum_buffer"].mul_(
                        group["momentum"]).add_(upd)
                p.sub_(upd)


def capturable(optimizer):
    """``optimizer`` (as :meth:`Config.build_optimizer` makes it, before its
    first update) in the form a CUDA graph of the train step can replay,
    over the same parameter groups and hyperparameters: ``torch.optim.SGD``
    becomes :class:`SGD`, :class:`RMSProp` and ``torch.optim.Adam`` /
    ``AdamW`` keep their class with the learning rate a 0-d tensor on the
    parameters' device, the latter two with ``capturable=True`` on the
    card. Forms that are capturable already come back as they are."""
    if is_capturable(optimizer):
        return optimizer
    kind = type(optimizer)
    if kind is RMSProp:
        for g in optimizer.param_groups:
            g["lr"] = _lr_tensor(g["lr"], g["params"])
        return optimizer
    if kind not in (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW):
        raise ValueError("no capturable form of {}".format(kind.__name__))
    if optimizer.state:
        raise ValueError("make the optimizer capturable before its first "
                         "update")
    groups = [dict(g) for g in optimizer.param_groups]
    if kind is torch.optim.SGD:
        for g in groups:
            if g["dampening"] or g["maximize"]:
                raise ValueError("SGD with dampening or maximize has no "
                                 "capturable form")
        return SGD([{k: g[k] for k in ("params", "lr", "momentum",
                                       "weight_decay", "nesterov")}
                    for g in groups], lr=groups[0]["lr"])
    on_card = groups[0]["params"][0].is_cuda
    for g in groups:
        g.update(lr=_lr_tensor(g["lr"], g["params"]), capturable=on_card,
                 foreach=on_card, fused=None)
    return kind(groups, lr=groups[0]["lr"])


def is_capturable(optimizer):
    """True when a CUDA graph can replay ``optimizer.step()`` and
    :func:`set_lr` reaches it: every learning rate is a tensor and, for
    Adam and AdamW, ``capturable`` is set where the parameters are on the
    card."""
    if not all(torch.is_tensor(g["lr"]) for g in optimizer.param_groups):
        return False
    if isinstance(optimizer, (SGD, RMSProp)):
        return True
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return all(g["capturable"] or not g["params"][0].is_cuda
                   for g in optimizer.param_groups)
    return False


def set_lr(optimizer, lr):
    """Give every parameter group the learning rate ``lr``: written into
    the group's tensor where it has one (on the card a fill, no sync), else
    set as a float."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


class Config:
    """``Config(path, learning_rate, batch_size, iters)``: the merged YAML
    dictionary (``.dic``) with the three overrides applied, and the
    objects it describes."""

    def __init__(self, path: str, learning_rate: float = None,
                 batch_size: int = None, iters: int = None):
        if not path:
            raise ValueError("Please specify the configuration file path.")
        if not os.path.exists(path):
            raise FileNotFoundError("File {} does not exist".format(path))
        if not (path.endswith("yml") or path.endswith("yaml")):
            raise RuntimeError("Config file should in yaml format!")
        self.dic = parse_from_yaml(path)
        self._model = None
        self._losses = None
        self._train_dataset = None
        self._val_dataset = None
        self.update(learning_rate=learning_rate, batch_size=batch_size,
                    iters=iters)

    def update(self, learning_rate=None, batch_size=None, iters=None):
        """Overrides, as the command line gives them."""
        if learning_rate:
            if "lr_scheduler" in self.dic:
                self.dic["lr_scheduler"]["learning_rate"] = learning_rate
            else:
                self.dic.setdefault("learning_rate",
                                    {})["value"] = learning_rate
        if batch_size:
            self.dic["batch_size"] = batch_size
        if iters:
            self.dic["iters"] = iters

    @property
    def batch_size(self) -> int:
        return self.dic.get("batch_size", 1)

    @property
    def iters(self) -> int:
        iters = self.dic.get("iters")
        if not iters:
            raise RuntimeError(
                "No iters specified in the configuration file.")
        return iters

    # ------------------------------------------------------------------
    # LR schedule
    # ------------------------------------------------------------------
    @property
    def lr_scheduler(self) -> Callable[[int], float]:
        """The schedule of the ``lr_scheduler`` block."""
        if "lr_scheduler" not in self.dic:
            raise RuntimeError(
                "No `lr_scheduler` specified in the configuration file.")
        params = self.dic.get("lr_scheduler").copy()
        return self._build_schedule(params.pop("type"), params)

    def _build_schedule(self, lr_type, params):
        if lr_type == "PolynomialDecay":
            return polynomial_decay(
                params["learning_rate"],
                params.get("decay_steps", None) or self.iters,
                params.get("end_lr", 0), params.get("power", 0.9))
        if lr_type == "PiecewiseDecay":
            return piecewise_decay(params["boundaries"], params["values"])
        if lr_type == "StepDecay":
            return step_decay(params["learning_rate"], params["step_size"],
                              params.get("gamma", 0.1))
        if lr_type == "CosineAnnealingDecay":
            return cosine_annealing_decay(
                params["learning_rate"], params.get("T_max") or self.iters,
                params.get("eta_min", 0.0))
        raise RuntimeError("Unknown lr_scheduler type {}.".format(lr_type))

    @property
    def learning_rate(self) -> Callable[[int], float]:
        """The legacy ``learning_rate`` block."""
        logger.warning(
            "`learning_rate` in configuration file will be deprecated, "
            "please use `lr_scheduler` instead.")
        _learning_rate = self.dic.get("learning_rate", {})
        if isinstance(_learning_rate, float):
            return lambda step: _learning_rate
        _learning_rate = self.dic.get("learning_rate", {}).get("value")
        if not _learning_rate:
            raise RuntimeError(
                "No learning rate specified in the configuration file.")
        args = self.decay_args
        decay_type = args.pop("type")
        if decay_type == "poly":
            return polynomial_decay(
                _learning_rate, args.get("decay_steps", self.iters),
                args.get("end_lr", 0), args.get("power", 0.9))
        if decay_type == "piecewise":
            return piecewise_decay(args["boundaries"], _learning_rate)
        if decay_type == "stepdecay":
            return self._build_schedule(
                "StepDecay", {"learning_rate": _learning_rate, **args})
        raise RuntimeError("Only poly and piecewise decay support.")

    @property
    def decay_args(self) -> dict:
        args = self.dic.get("learning_rate", {}).get(
            "decay", {"type": "poly", "power": 0.9}).copy()
        if args["type"] == "poly":
            args.setdefault("decay_steps", self.iters)
            args.setdefault("end_lr", 0)
        return args

    # ------------------------------------------------------------------
    # Optimizer
    # ------------------------------------------------------------------
    @property
    def optimizer_args(self) -> dict:
        args = self.dic.get("optimizer", {}).copy()
        if args.get("type") == "sgd":
            args.setdefault("momentum", 0.9)
        return args

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        """A new optimizer over ``self.model``'s parameters, see
        :meth:`build_optimizer`."""
        return self.build_optimizer(self.model.parameters())

    def build_optimizer(self, params) -> torch.optim.Optimizer:
        """The configured optimizer over ``params``. ``weight_decay`` is
        coupled L2 on every parameter, BatchNorm and biases included
        (``optax.add_decayed_weights`` before the optimizer), except for
        adamw, which decays decoupled. The learning rate starts at the
        schedule's value for step 0."""
        schedule = (self.lr_scheduler if "lr_scheduler" in self.dic
                    else self.learning_rate)
        args = self.optimizer_args
        kind = args.pop("type")
        wd = args.pop("weight_decay", 0.0)
        lr = schedule(0)
        if kind in ("sgd", "momentum", "Momentum"):
            return torch.optim.SGD(
                params, lr=lr, momentum=args.get("momentum", 0.9),
                nesterov=args.get("use_nesterov", False), weight_decay=wd)
        betas = (args.get("beta1", 0.9), args.get("beta2", 0.999))
        if kind == "adam":
            return torch.optim.Adam(params, lr=lr, betas=betas,
                                    eps=args.get("epsilon", 1e-8),
                                    weight_decay=wd)
        if kind in ("adamw", "AdamW"):
            return torch.optim.AdamW(params, lr=lr, betas=betas,
                                     eps=args.get("epsilon", 1e-8),
                                     weight_decay=wd)
        if kind in ("rmsprop", "RMSProp"):
            return RMSProp(params, lr=lr, rho=args.get("rho", 0.95),
                           eps=args.get("epsilon", 1e-6),
                           momentum=args.get("momentum", 0.0),
                           weight_decay=wd)
        raise RuntimeError("Unknown optimizer type {}.".format(kind))

    # ------------------------------------------------------------------
    # Loss
    # ------------------------------------------------------------------
    @property
    def loss(self) -> dict:
        if self._losses is None:
            self._losses = self._prepare_loss("loss")
        return self._losses

    def _prepare_loss(self, loss_name):
        args = self.dic.get(loss_name, {}).copy()
        if "types" not in args or "coef" not in args:
            raise ValueError(
                'Loss config should contain keys of "types" and "coef"')
        len_types, len_coef = len(args["types"]), len(args["coef"])
        if len_types != len_coef:
            if len_types != 1:
                raise ValueError(
                    "The length of types should equal to coef or equal "
                    "to 1 in loss config, but they are {} and {}."
                    .format(len_types, len_coef))
            args["types"] = args["types"] * len_coef
        # the train dataset's ignore_index (255, every dataset's default,
        # when its section leaves it out), read without loading the data
        ds_ignore = self.dic.get("train_dataset", {}).get("ignore_index",
                                                          255)
        losses = dict(args)
        losses["types"] = []
        for item in args["types"]:
            item = dict(item)
            if item["type"] != "MixedLoss":
                if item.get("ignore_index", ds_ignore) != ds_ignore:
                    raise ValueError(
                        "If ignore_index of loss is set, it must equal the "
                        "train_dataset ignore_index.")
                item["ignore_index"] = ds_ignore
            losses["types"].append(self._load_object(item))
        return losses

    # ------------------------------------------------------------------
    # Model
    # ------------------------------------------------------------------
    @property
    def model(self) -> torch.nn.Module:
        """The model of the ``model`` section; without ``num_classes`` it
        takes the train dataset's (else the val dataset's)."""
        model_cfg = dict(self.dic.get("model", {}))
        if not model_cfg:
            raise RuntimeError(
                "No model specified in the configuration file.")
        if "num_classes" not in model_cfg:
            ds = (self.train_dataset if self.train_dataset_config
                  else self.val_dataset)
            if getattr(ds, "num_classes", None) is not None:
                model_cfg["num_classes"] = ds.num_classes
        if self._model is None:
            self._model = build_model(model_cfg)
        return self._model

    # ------------------------------------------------------------------
    # Datasets
    # ------------------------------------------------------------------
    def _dataset_config(self, name):
        cfg = dict(self.dic.get(name, {}))
        if cfg:
            for key in ("dataset_root", "result_dir"):
                if cfg.get(key) is not None:
                    cfg[key] = os.path.join(self.dic.get("data_root", ""),
                                            cfg[key])
        return cfg

    @property
    def train_dataset_config(self) -> Dict:
        return self._dataset_config("train_dataset")

    @property
    def val_dataset_config(self) -> Dict:
        return self._dataset_config("val_dataset")

    @property
    def train_dataset(self):
        if self._train_dataset is None and self.train_dataset_config:
            self._train_dataset = self._load_object(self.train_dataset_config)
        return self._train_dataset

    @property
    def val_dataset(self):
        if self._val_dataset is None and self.val_dataset_config:
            self._val_dataset = self._load_object(self.val_dataset_config)
        return self._val_dataset

    def data_root_path_warning(self):
        """Raise without ``data_root``; warn where it is the default
        ``data/``."""
        if "data_root" not in self.dic:
            raise RuntimeError(
                "The dataroot need to be set in the config file")
        data_root = self.dic["data_root"]
        if data_root == "data/":
            warnings.warn(
                "Warning: The data dir now is {}, you should change the "
                "data_root in the global.yml if this directory didn't "
                "have enough space".format(os.path.join(os.getcwd(),
                                                        data_root)))

    # ------------------------------------------------------------------
    # Reflective loading
    # ------------------------------------------------------------------
    def _load_component(self, com_name: str) -> Any:
        from .. import datasets, models, transforms  # noqa: F401 (registries)
        for com in (manager.MODELS, manager.BACKBONES, manager.DATASETS,
                    manager.TRANSFORMS, manager.LOSSES):
            if com_name in com.components_dict:
                return com[com_name]
        raise RuntimeError(
            "The specified component was not found {}.".format(com_name))

    def _load_object(self, cfg: dict) -> Any:
        cfg = cfg.copy()
        if "type" not in cfg:
            raise RuntimeError("No object information in {}.".format(cfg))
        component = self._load_component(cfg.pop("type"))
        params = {}
        for key, val in cfg.items():
            if self._is_meta_type(val):
                params[key] = self._load_object(val)
            elif isinstance(val, list):
                params[key] = [self._load_object(item)
                               if self._is_meta_type(item) else item
                               for item in val]
            else:
                params[key] = val
        return component(**params)

    def _is_meta_type(self, item: Any) -> bool:
        return isinstance(item, dict) and "type" in item

    def __str__(self) -> str:
        return yaml.dump(self.dic)
