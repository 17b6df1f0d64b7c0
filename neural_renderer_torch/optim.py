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
"""

import torch


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
                if scale == 0:
                    continue              # optimizers.py:17-18 'if lr != 0'
                t = torch.tensor(float(state['step']), dtype=torch.float32,
                                 device=p.device)
                lr_t = alpha * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
                g, m, v = p.grad, state['m'], state['v']
                active = g != 0.0         # optimizers.py:23 'if (grad != 0)'
                m.copy_(torch.where(active, m + (1 - b1) * (g - m), m))
                v.copy_(torch.clamp(
                    torch.where(active, v + (1 - b2) * (g * g - v), v),
                    min=0.0))
                p.add_(torch.where(
                    active, -lr_t * scale * m / (torch.sqrt(v) + eps), 0.0))
        return loss
