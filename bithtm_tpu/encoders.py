"""SDR encoders: scalars, categories, datetimes -> sparse binary vectors.

The reference operates on raw random binary patterns only (`example.py:34`);
real HTM pipelines (NAB-style anomaly detection — BASELINE.json configs[3])
need encoders that map input values to sparse distributed representations
with the classic HTM property: nearby values share active bits, distant
values share none.

All encoders are pure functions on jnp arrays, batch-friendly (leading
axes broadcast) and jittable, producing bool SDRs that feed
`HierarchicalTemporalMemory.process` / `htm_step` directly — except
`DateTimeEncoder.encode`, which needs concrete host-side datetimes
(calendar math) and must NOT be wrapped in `jit`; encode on the host,
then feed the resulting SDRs to the jitted step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class ScalarEncoder:
    """Classic HTM scalar encoder: a contiguous run of `active_bits` ones
    whose position slides linearly with the value over [minimum, maximum]
    (clipped). Overlap between two encodings decays linearly with value
    distance — the HTM similarity contract."""

    minimum: float
    maximum: float
    size: int = 400
    active_bits: int = 21

    @property
    def buckets(self) -> int:
        return self.size - self.active_bits + 1

    def __call__(self, value) -> jnp.ndarray:
        v = jnp.clip(
            (jnp.asarray(value, jnp.float32) - self.minimum)
            / (self.maximum - self.minimum),
            0.0, 1.0,
        )
        start = jnp.round(v * (self.buckets - 1)).astype(jnp.int32)
        i = jnp.arange(self.size, dtype=jnp.int32)
        s = start[..., None]
        return (i >= s) & (i < s + self.active_bits)


@dataclasses.dataclass(frozen=True)
class CyclicEncoder:
    """Scalar encoder on a circle (hour-of-day, day-of-week): the active
    run wraps, so maximum and minimum encode adjacently."""

    period: float
    size: int = 128
    active_bits: int = 11

    def __call__(self, value) -> jnp.ndarray:
        phase = jnp.mod(jnp.asarray(value, jnp.float32), self.period)
        start = jnp.floor(phase / self.period * self.size).astype(jnp.int32)
        i = jnp.arange(self.size, dtype=jnp.int32)
        off = jnp.mod(i - start[..., None], self.size)
        return off < self.active_bits


@dataclasses.dataclass(frozen=True)
class CategoryEncoder:
    """Disjoint one-hot blocks of `active_bits` per category: no overlap
    between distinct categories."""

    categories: int
    active_bits: int = 15

    @property
    def size(self) -> int:
        return self.categories * self.active_bits

    def __call__(self, index) -> jnp.ndarray:
        idx = jnp.asarray(index, jnp.int32)
        i = jnp.arange(self.size, dtype=jnp.int32)
        s = (idx * self.active_bits)[..., None]
        return (i >= s) & (i < s + self.active_bits)


@dataclasses.dataclass(frozen=True)
class DateTimeEncoder:
    """NAB-style timestamp context: cyclic hour-of-day + day-of-week.
    Input is integer seconds-since-epoch (or any consistent origin).

    The phase reduction happens host-side in int64 (exact for any
    timestamp) — reducing current-era epoch values in float32 would
    quantize them to its 128-second ulp, aliasing nearby minutes, and
    int32 would overflow in 2038. Consequence: this encoder needs
    concrete (host) values, not jit tracers — encode timestamps outside
    jit (they come from the data pipeline anyway)."""

    hour_size: int = 128
    hour_bits: int = 11
    weekday_size: int = 64
    weekday_bits: int = 9

    @property
    def size(self) -> int:
        return self.hour_size + self.weekday_size

    def __call__(self, epoch_seconds) -> jnp.ndarray:
        import numpy as np

        t = np.asarray(jax.device_get(epoch_seconds)).astype(np.int64)
        day_phase = jnp.asarray((t % 86400).astype(np.float32))
        week_phase = jnp.asarray((t % (7 * 86400)).astype(np.float32))
        hour = CyclicEncoder(86400.0, self.hour_size,
                             self.hour_bits)(day_phase)
        # epoch day 0 (1970-01-01) was a Thursday; weekday phase only
        # needs consistency, not calendar alignment
        wday = CyclicEncoder(7 * 86400.0, self.weekday_size,
                             self.weekday_bits)(week_phase)
        return jnp.concatenate([hour, wday], axis=-1)


def concat(*sdrs: jnp.ndarray) -> jnp.ndarray:
    """Concatenate encoder outputs into one input SDR."""
    return jnp.concatenate(sdrs, axis=-1)


def anomaly_score(prev_predicted_columns: np.ndarray,
                  active_columns: np.ndarray) -> float:
    """NAB/Numenta raw anomaly score: fraction of currently active
    columns that were NOT predicted by the previous step. The in-step
    `metrics['anomaly']` (bursting / active_columns) is the same
    quantity computed on-device."""
    active = np.asarray(active_columns, bool)
    pred = np.asarray(prev_predicted_columns, bool)
    n_active = active.sum()
    if n_active == 0:
        return 0.0
    return float((active & ~pred).sum() / n_active)


# ---- anomaly likelihood (serving-side post-processing) -----------------
# Raw anomaly scores are noisy; production anomaly detection (the NAB
# protocol) thresholds the *likelihood*: the Gaussian tail probability
# of the recent short-term mean score under the stream's own running
# score distribution. Absent in the reference (which only prints raw
# column counts); implemented here as a fixed-size, fully jittable
# state so it can ride inside `lax.scan` next to the model step.


class AnomalyLikelihoodState(NamedTuple):
    scores: jnp.ndarray      # (W,) ring buffer of raw scores
    pos: jnp.ndarray         # () int32 next write position
    count: jnp.ndarray       # () int32 total scores seen (saturates at W)
    short_mean: jnp.ndarray  # () f32 EMA of recent scores


def anomaly_likelihood_init(window: int = 500) -> AnomalyLikelihoodState:
    return AnomalyLikelihoodState(
        scores=jnp.zeros((window,), jnp.float32),
        pos=jnp.zeros((), jnp.int32),
        count=jnp.zeros((), jnp.int32),
        short_mean=jnp.zeros((), jnp.float32),
    )


def anomaly_likelihood_update(
    state: AnomalyLikelihoodState,
    score: jnp.ndarray,
    short_momentum: float = 0.9,
    exclude_recent: int = 10,
) -> tuple[AnomalyLikelihoodState, jnp.ndarray]:
    """Push one raw anomaly score; returns (new_state, likelihood in
    [0, 1]). Likelihood ~0.5 for in-distribution scores, -> 1 when the
    recent short-term mean sits far in the upper tail of the stream's
    own running score distribution. Threshold around 0.99999 for
    NAB-style alerts (equivalently ``-log10(1 - L) >= 5``).

    The distribution is estimated EXCLUDING the newest
    ``exclude_recent`` samples (the Numenta construction): an anomaly
    burst must not contaminate the baseline it is being judged
    against, or the alert collapses before it fires. Until enough
    history exists the likelihood is held at 0.5 (undecided)."""
    W = state.scores.shape[0]
    R = exclude_recent
    if W < R + 10:
        raise ValueError(
            f"anomaly-likelihood window ({W}) must be at least "
            f"exclude_recent + 10 ({R + 10}); otherwise the warm-up "
            f"gate never opens and the likelihood stays 0.5 forever"
        )
    score = jnp.asarray(score, jnp.float32)
    scores = state.scores.at[state.pos].set(score)
    pos = (state.pos + 1) % W  # keep pos in [0, W): no int32 wrap drift
    count = jnp.minimum(state.count + 1, W)
    short = (short_momentum * jnp.where(state.count > 0, state.short_mean,
                                        score)
             + (1.0 - short_momentum) * score)

    # age 0 = newest; estimate over samples older than R
    slot = jnp.arange(W, dtype=jnp.int32)
    age = (pos - 1 - slot) % W
    est = (age >= R) & (age < count)
    n = jnp.maximum(est.sum(), 1).astype(jnp.float32)
    mean = jnp.where(est, scores, 0.0).sum() / n
    var = jnp.where(est, (scores - mean) ** 2, 0.0).sum() / n
    std = jnp.sqrt(jnp.maximum(var, 1e-8))
    # Gaussian upper-tail CDF of the short-term mean
    z = (short - mean) / std
    likelihood = 0.5 * (1.0 + jax.scipy.special.erf(z / jnp.sqrt(2.0)))
    likelihood = jnp.where(count >= R + 10, likelihood, 0.5)
    return (
        AnomalyLikelihoodState(scores=scores, pos=pos, count=count,
                               short_mean=short),
        likelihood,
    )


# ---- windowed z-score residual stage (pre-encoder / side detector) -----
# The likelihood post-processor fails in two measured ways
# (docs/QUALITY.md "Anomaly benchmark"): chronic input noise widens
# the running score Gaussian until a one-step spike can't reach the
# tail, and continuous drift shifts the score distribution the same
# way. The standard NAB-era mitigation is a seasonal-residual windowed
# z-score stage: r[t] = v[t] - v[t - period] cancels both seasonality
# and slow drift, and a causal windowed z-score of r flags point/level
# anomalies that the score-distribution path absorbs. Use it in front
# of the encoder (as an extra input channel) and/or as a side detector
# union-ed with the likelihood alerts (`examples/anomaly_benchmark.py`
# does the latter).


class SeasonalZScoreState(NamedTuple):
    lag: jnp.ndarray    # (lags * period,) ring of raw values
    resid: jnp.ndarray  # (window,) ring of residuals
    pos: jnp.ndarray    # () int32 step counter


def seasonal_zscore_init(period: int, window: int = 96,
                         lags: int = 3) -> SeasonalZScoreState:
    if lags < 1 or lags % 2 == 0:
        raise ValueError(f"lags must be odd >= 1, got {lags} (the "
                         f"seasonal baseline is a median over lags)")
    return SeasonalZScoreState(
        lag=jnp.zeros((lags * period,), jnp.float32),
        resid=jnp.zeros((window,), jnp.float32),
        pos=jnp.zeros((), jnp.int32),
    )


def seasonal_zscore_update(
    state: SeasonalZScoreState, value, period: int,
    eps: float = 1e-6,
) -> tuple[SeasonalZScoreState, jnp.ndarray]:
    """Streaming form of `seasonal_zscore`: push one value, get its z.

    The seasonal baseline is the MEDIAN of the last `lags` same-phase
    values (``v[t - period], v[t - 2*period], ...``): a single
    anomalous cycle cannot move it, which kills the "seasonal echo"
    false alert one period after a spike that a plain
    ``v[t] - v[t - period]`` residual produces. Rides inside
    `lax.scan` next to the model step like `anomaly_likelihood_update`.
    """
    L = state.lag.shape[0]
    W = state.resid.shape[0]
    k = L // period
    v = jnp.asarray(value, jnp.float32)
    t = state.pos
    seas = jnp.stack([state.lag[(t - (i + 1) * period) % L]
                      for i in range(k)])
    r = jnp.where(t >= L, v - jnp.median(seas), 0.0)
    # stats over the current ring BEFORE inserting r (ages 1..window)
    n = jnp.clip(t, 1, W).astype(jnp.float32)
    live = jnp.arange(W) < jnp.minimum(t, W)
    s1 = jnp.where(live, state.resid, 0.0).sum()
    s2 = jnp.where(live, state.resid * state.resid, 0.0).sum()
    mean = s1 / n
    var = jnp.maximum(s2 / n - mean * mean, eps)
    z = jnp.where(t >= L + W, (r - mean) / jnp.sqrt(var), 0.0)
    return SeasonalZScoreState(
        lag=state.lag.at[t % L].set(v),
        resid=state.resid.at[t % W].set(r),
        pos=t + 1,
    ), z


def seasonal_zscore(values, period: int, window: int = 96,
                    lags: int = 3, eps: float = 1e-6) -> jnp.ndarray:
    """Causal windowed z-score of the seasonal residual, whole-array.

    ``r[t] = v[t] - median(v[t - period], ..., v[t - lags*period])``;
    ``z[t]`` standardizes ``r[t]`` against the mean/std of the
    PRECEDING ``window`` residuals (excluding ``r[t]`` itself, so a
    spike cannot deflate its own z). The first
    ``lags * period + window`` steps emit 0 (insufficient history).
    Implemented as a `lax.scan` of `seasonal_zscore_update`, so the
    streaming form is bit-identical by construction. Jittable.
    """
    v = jnp.asarray(values, jnp.float32)

    def f(st, x):
        return seasonal_zscore_update(st, x, period, eps)

    _, z = jax.lax.scan(f, seasonal_zscore_init(period, window, lags), v)
    return z


# ---- alerting + task-level scoring (host-side, NAB protocol) -----------
# Turning a likelihood stream into discrete alerts and scoring them
# against labeled anomaly windows is the last mile of the NAB protocol.
# Host-side by design: it runs on the already-materialized score stream
# after the device loop, at O(alerts) cost.


def alert_episodes(detect_steps, merge_gap: int):
    """Merge sorted detection step indices into (start, end) alerts.

    ``detect_steps`` is an ascending iterable of step indices where the
    detector fired (e.g. ``np.flatnonzero(nlog >= threshold)``);
    consecutive detections closer than ``merge_gap`` steps belong to
    the same alert episode."""
    episodes: list[list[int]] = []
    for s in detect_steps:
        s = int(s)
        if episodes and s - episodes[-1][1] <= merge_gap:
            episodes[-1][1] = s
        else:
            episodes.append([s, s])
    return [(a, b) for a, b in episodes]


def score_alert_windows(episodes, windows):
    """NAB-style window-level confusion for a set of alerts.

    ``episodes`` are (start, end) alerts (see `alert_episodes`);
    ``windows`` are (start, end) ground-truth anomaly windows. A window
    counts as detected iff at least one alert overlaps it; an alert
    overlapping no window is a false positive. Returns a dict with
    ``tp`` / ``fp`` / ``fn`` / ``precision`` / ``recall`` / ``f1``."""
    tp_windows = 0
    matched = [False] * len(episodes)
    for w0, w1 in windows:
        hit = False
        for i, (a0, a1) in enumerate(episodes):
            if a0 <= w1 and a1 >= w0:
                matched[i] = True
                hit = True
        tp_windows += hit
    fp = matched.count(False)
    fn = len(windows) - tp_windows
    precision = tp_windows / max(tp_windows + fp, 1)
    recall = tp_windows / max(len(windows), 1)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return dict(tp=tp_windows, fp=fp, fn=fn, precision=precision,
                recall=recall, f1=f1)
