"""erf via the Abramowitz & Stegun 7.1.26 polynomial (max abs error
~1.5e-7), the polynomial the JAX package's float path uses instead of a
libm erf; ``fast_erf`` is its bf16 serving-mode tanh form."""
from __future__ import annotations

import torch

from ..intops import replays_xla, xla_cpu_exp

_A1 = 0.254829592
_A2 = -0.284496736
_A3 = 1.421413741
_A4 = -1.453152027
_A5 = 1.061405429
_P = 0.3275911

# erf(u) ~ tanh(t1*u + t3*u^3) = 2*sigmoid(2*(t1*u + t3*u^3)) - 1,
# max abs error 3.6e-4
_SIG_K1 = 2.2567583341910256
_SIG_K3 = 0.2018218978267034


def erf(x: torch.Tensor) -> torch.Tensor:
    from .. import config
    if config.float_dtype == torch.bfloat16:
        return fast_erf(x)
    return exact_erf(x)


def exact_erf(x: torch.Tensor) -> torch.Tensor:
    sign = torch.sign(x)
    x = torch.abs(x)
    t = 1.0 / (1.0 + _P * x)
    # on float32 CPU tensors the exp is XLA's, as the JAX package's jnp.exp
    # computes it there
    ex = xla_cpu_exp(-x * x) if replays_xla(x) else torch.exp(-x * x)
    y = 1.0 - (((((_A5 * t + _A4) * t) + _A3) * t + _A2) * t + _A1) * t \
        * ex
    return sign * y


def fast_erf(x: torch.Tensor) -> torch.Tensor:
    z = x * (_SIG_K1 + _SIG_K3 * (x * x))
    return 2.0 * torch.sigmoid(z) - 1.0
