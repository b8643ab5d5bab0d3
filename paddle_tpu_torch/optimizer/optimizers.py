"""SGD, Adam and AdamW; counterpart of
``paddle_tpu/optimizer/optimizers.py``.

SGD is ``p - lr * g`` in torch (no kernel: the JAX package's is a plain
update too), on the fp32 master under ``multi_precision``.

Each step launches the fused AdamW kernel (K3, ``ops.fused_adamw``) once
per parameter with a gradient.  The bias-correction powers are fp32
device scalars per parameter, multiplied by the betas every step
(``beta1_pow``/``beta2_pow`` in the JAX package); AdamW's decoupled decay
``p * (1 - lr * wd)`` runs inside the same kernel.  On CPU tensors the
kernel's plain version runs instead, the unfused sequence of
``Adam._adam_update``.
"""
from __future__ import annotations

import torch

from ..ops.fused_adamw import fused_adamw_update_
from .optimizer import Optimizer

__all__ = ["SGD", "Adam", "AdamW"]


class SGD(Optimizer):
    """``p - lr * g`` (ref: ``python/paddle/optimizer/sgd.py``);
    ``weight_decay`` waits for a later slice and raises
    ``NotImplementedError`` when set."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if weight_decay:
            raise NotImplementedError("L2 regularization in SGD waits for "
                                      "a later slice")
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)

    def _update_param(self, p, g):
        lr = self._lr_on(p.device)
        if self._use_master(p):
            st = self.state[p]
            if not st:
                st["master"] = p.detach().float().clone()
            st["master"].sub_(lr * g.float())
            p.copy_(st["master"])
        else:
            p.sub_((lr * g).to(p.dtype))


class Adam(Optimizer):
    """``lazy_mode``, ``use_multi_tensor`` and ``amsgrad`` wait for a later
    slice and raise ``NotImplementedError`` when set."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        if weight_decay:
            raise NotImplementedError("L2 regularization in Adam waits for "
                                      "a later slice (AdamW decays "
                                      "decoupled)")
        if lazy_mode:
            raise NotImplementedError("lazy_mode waits for a later slice")
        if use_multi_tensor:
            raise NotImplementedError("use_multi_tensor waits for a later "
                                      "slice (each parameter launches K3)")
        if amsgrad:
            raise NotImplementedError("amsgrad waits for a later slice")
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._betas = {}        # device -> fp32 tensor [beta1, beta2]

    def _state(self, p):
        st = self.state[p]
        if not st:
            dev = p.device
            st["moment1"] = torch.zeros(p.shape, dtype=torch.float32,
                                        device=dev)
            st["moment2"] = torch.zeros_like(st["moment1"])
            st["beta_pows"] = torch.ones(2, dtype=torch.float32, device=dev)
            if self._use_master(p):
                st["master"] = p.detach().float().clone()
        return st

    def _checkpoint_state(self, p):
        return self._state(p)

    def _adam_update(self, p, g, lr, wd):
        st = self._state(p)
        betas = self._betas.get(p.device)
        if betas is None:
            betas = torch.tensor([self._beta1, self._beta2],
                                 dtype=torch.float32, device=p.device)
            self._betas[p.device] = betas
        pows = st["beta_pows"]
        pows.mul_(betas)
        master = st.get("master")
        if master is not None:
            fused_adamw_update_(master, g, st["moment1"], st["moment2"], lr,
                                pows[0:1], pows[1:2], self._beta1,
                                self._beta2, self._epsilon, wd, p_low=p)
        else:
            fused_adamw_update_(p, g, st["moment1"], st["moment2"], lr,
                                pows[0:1], pows[1:2], self._beta1,
                                self._beta2, self._epsilon, wd)

    def _update_param(self, p, g):
        self._adam_update(p, g, self._lr_on(p.device), 0.0)


class AdamW(Adam):
    """Decoupled weight decay (ref: python/paddle/optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        if not isinstance(weight_decay, (int, float)):
            raise NotImplementedError("regularizer objects wait for a later "
                                      "slice; pass a float weight_decay")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._weight_decay = weight_decay
        self._wd = float(weight_decay)
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update_param(self, p, g):
        lr = self._lr_on(p.device)
        if self._lr_ratio is not None:
            lr = lr * float(self._lr_ratio(p))
        wd = self._wd
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(getattr(p, "name", None)):
            wd = 0.0
        self._adam_update(p, g, lr, wd)
