"""FED step-size schedules and evolution allocation (own copy of the JAX
package's `akaze_tpu/core/fed.py`; pure host Python).

    n      = ceil(sqrt(3*T/tau_max + 0.25) - 0.5 - 1e-8)
    scale  = 3*T / (tau_max * n * (n+1))
    tau_j  = (scale * tau_max / 2) / cos^2(pi * (2j+1) / (4n+2))
    kappa-reordering: kappa = n//2, prime = smallest prime >= n+1.

At 640x480 with the default config this gives 16 levels in 4 octaves and
166 FED sweeps per frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

from akaze_tpu_torch.core.config import AkazeConfig


def fed_is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def _next_prime(n: int) -> int:
    while not fed_is_prime(n):
        n += 1
    return n


def fed_tau_internal(n: int, scale: float, tau_max: float, reordering: bool) -> List[float]:
    """The n cosine-spaced FED step sizes, optionally kappa-reordered."""
    if n <= 0:
        return []
    c = 1.0 / (4.0 * n + 2.0)
    d = scale * tau_max / 2.0
    tauh = [d / (math.cos(math.pi * (2 * j + 1) * c) ** 2) for j in range(n)]
    if not reordering or n == 1:
        return tauh
    kappa = n // 2
    prime = _next_prime(n + 1)
    tau = []
    k = 0
    for _ in range(n):
        while True:
            index = ((k + 1) * kappa) % prime - 1
            if index < n:
                break
            k += 1
        tau.append(tauh[index])
        k += 1
    return tau


def fed_tau_by_cycle_time(t: float, tau_max: float = 0.25, reordering: bool = True) -> List[float]:
    n = int(math.ceil(math.sqrt(3.0 * t / tau_max + 0.25) - 0.5 - 1.0e-8))
    scale = 3.0 * t / (tau_max * n * (n + 1))
    return fed_tau_internal(n, scale, tau_max, reordering)


def fed_tau_by_process_time(
    T: float, num_cycles: int = 1, tau_max: float = 0.25, reordering: bool = True
) -> List[float]:
    """Step sizes covering total diffusion time T with `num_cycles` cycles."""
    return fed_tau_by_cycle_time(T / num_cycles, tau_max, reordering)


@dataclasses.dataclass(frozen=True)
class EvolutionSpec:
    """Static description of one scale-space level."""

    index: int
    octave: int
    sublevel: int
    esigma: float  # sigma0 * 2^(octave + sublevel/num_sublevels), octave-0 units
    etime: float  # sigma^2 / 2
    width: int
    height: int
    sigma_size: int  # round(esigma * derivative_factor / 2^octave), level px
    border: int  # extrema border: round(smax * sigma_size) + 1, level px
    taus: tuple  # FED step sizes taking level (index-1) -> this level

    @property
    def ratio(self) -> int:
        return 1 << self.octave


def _round_half_up(x: float) -> int:
    return int(math.floor(x + 0.5))


def allocate_evolutions(width: int, height: int, config: AkazeConfig) -> List[EvolutionSpec]:
    """Octaves * sublevels levels, dropping downsampled octaves whose min
    dimension falls below config.min_octave_dim (octave 0 always stays)."""
    evolutions: List[EvolutionSpec] = []
    prev_etime = 0.0
    w, h = width, height
    for octave in range(config.num_octaves):
        if octave > 0 and min(w, h) < config.min_octave_dim:
            break
        for sublevel in range(config.num_sublevels):
            esigma = config.base_scale_offset * math.pow(
                2.0, octave + sublevel / config.num_sublevels
            )
            etime = 0.5 * esigma * esigma
            sigma_size = _round_half_up(esigma * config.derivative_factor / (1 << octave))
            border = _round_half_up(config.border_smax * sigma_size) + 1
            index = len(evolutions)
            if index == 0:
                taus: Sequence[float] = ()
            else:
                taus = tuple(
                    fed_tau_by_process_time(
                        etime - prev_etime, 1, config.fed_tau_max, reordering=True
                    )
                )
            evolutions.append(
                EvolutionSpec(
                    index=index, octave=octave, sublevel=sublevel, esigma=esigma,
                    etime=etime, width=w, height=h, sigma_size=sigma_size,
                    border=border, taus=taus,
                )
            )
            prev_etime = etime
        w, h = w // 2, h // 2
    return evolutions
