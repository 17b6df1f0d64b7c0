"""Custom Adam: element-wise zero-gradient skip and per-parameter LR scales.

Reference ``neural_renderer/optimizers.py`` and the JAX package's
``optim.py``: an Adam whose update (a) leaves m, v and the parameter
untouched wherever ``grad == 0.0``, which matters here because the
rasterizer backward writes exact zeros for faces and texels that touch no
pixel, and plain Adam would keep moving them on momentum; and (b) multiplies
the learning rate by a per-parameter scale (the reference's ``param.lr``),
skipping the parameter entirely, m and v included, where the scale is 0.

The step size is Chainer's bias-corrected
``lr_t = alpha * sqrt(1 - beta2^t) / (1 - beta1^t)``, computed in float32
as the JAX package does.

Two forms share one per-element update (``_leaf``): the optimizer class
``Adam`` and the functional ``adam``, the JAX package's optax-style
``(init_fn, update_fn)`` over dicts of tensors, which the data-parallel
step (``parallel.make_data_parallel_train_step``) takes.
"""

import torch


def _lr_t(alpha, b1, b2, count, device):
    """Chainer's bias-corrected step size at step ``count``, f32."""
    t = torch.tensor(float(count), dtype=torch.float32, device=device)
    return alpha * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)


def _leaf(g, m, v, lr_t, scale, b1, b2, eps):
    """One parameter's (update to add, new m, new v).  Elements whose
    gradient is 0 keep m, v and the parameter (optimizers.py:23 'if (grad
    != 0)'); a scale of 0 freezes them all (optimizers.py:17-18 'if lr !=
    0')."""
    active = (g != 0.0) & (scale != 0)
    m_new = torch.where(active, m + (1 - b1) * (g - m), m)
    v_new = torch.clamp(torch.where(active, v + (1 - b2) * (g * g - v), v),
                        min=0.0)
    upd = torch.where(active, -lr_t * scale * m_new / (torch.sqrt(v_new) + eps),
                      0.0)
    return upd, m_new, v_new


def adam(alpha=0.001, beta1=0.9, beta2=0.999, eps=1e-8, lr_scales=None):
    """The functional form (JAX package ``optim.adam``): returns
    ``(init_fn, update_fn)``.

    ``init_fn(params)`` -> state dict(count, m, v) for a dict of tensors;
    ``update_fn(grads, state, params=None)`` -> (updates to add to the
    params, new state).  ``lr_scales``: an optional dict of per-parameter
    learning-rate multipliers (default 1.0)."""

    def init_fn(params):
        return dict(count=0,
                    m={k: torch.zeros_like(p) for k, p in params.items()},
                    v={k: torch.zeros_like(p) for k, p in params.items()})

    def update_fn(grads, state, params=None):
        del params
        count = state['count'] + 1
        updates, m_new, v_new = {}, {}, {}
        for k, g in grads.items():
            scale = 1.0 if lr_scales is None else lr_scales.get(k, 1.0)
            lr_t = _lr_t(alpha, beta1, beta2, count, g.device)
            updates[k], m_new[k], v_new[k] = _leaf(
                g, state['m'][k], state['v'][k], lr_t, scale, beta1, beta2,
                eps)
        return updates, dict(count=count, m=m_new, v=v_new)

    return init_fn, update_fn


class Adam(torch.optim.Optimizer):
    """``Adam(params, alpha=0.001, beta1=0.9, beta2=0.999, eps=1e-8)``.

    ``params`` is an iterable of tensors or of parameter groups; a group's
    ``lr_scale`` (default 1.0) scales its learning rate
    (``Mesh.lr_scales()`` builds such groups).  Call ``step()`` after
    ``backward()``; parameters without a gradient are skipped."""

    def __init__(self, params, alpha=0.001, beta1=0.9, beta2=0.999,
                 eps=1e-8):
        super().__init__(params, dict(alpha=alpha, beta1=beta1, beta2=beta2,
                                      eps=eps, lr_scale=1.0))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            alpha, b1, b2, eps, scale = (group[k] for k in (
                'alpha', 'beta1', 'beta2', 'eps', 'lr_scale'))
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['step'] = 0
                    state['m'] = torch.zeros_like(p)
                    state['v'] = torch.zeros_like(p)
                state['step'] += 1
                upd, m, v = _leaf(p.grad, state['m'], state['v'],
                                  _lr_t(alpha, b1, b2, state['step'],
                                        p.device), scale, b1, b2, eps)
                state['m'].copy_(m)
                state['v'].copy_(v)
                p.add_(upd)
        return loss
