"""SDR readout: decode HTM cell states back into value predictions.

The reference stops at column-level prediction metrics
(`example.py:55-57`). A complete sequence-prediction pipeline needs a
decoder from the TM's predictive cells to the input space — the classic
HTM "SDR classifier": an online multinomial logistic regression from a
cell SDR to value buckets, trained with plain SGD one step behind the
prediction (predict at t from the cells at t, learn at t+1 when the
actual bucket arrives).

Functional and jittable like everything else: state is a weight matrix
pytree, `update` returns a new state, and both batch with `vmap`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ClassifierState(NamedTuple):
    weights: jnp.ndarray   # (buckets, features) float32


def classifier_init(features: int, buckets: int) -> ClassifierState:
    return ClassifierState(
        weights=jnp.zeros((buckets, features), jnp.float32)
    )


def classifier_predict(state: ClassifierState,
                       sdr: jnp.ndarray) -> jnp.ndarray:
    """(features,) bool SDR -> (buckets,) probability distribution."""
    logits = jnp.dot(state.weights, sdr.astype(jnp.float32),
                     precision=jax.lax.Precision.HIGHEST)
    return jax.nn.softmax(logits)


def classifier_update(state: ClassifierState, sdr: jnp.ndarray,
                      target_bucket: jnp.ndarray,
                      learning_rate: float = 0.1) -> ClassifierState:
    """One online SGD step of cross-entropy toward the observed bucket."""
    x = sdr.astype(jnp.float32)
    probs = classifier_predict(state, sdr)
    onehot = jax.nn.one_hot(target_bucket, state.weights.shape[0])
    grad = (probs - onehot)[:, None] * x[None, :]
    return ClassifierState(weights=state.weights - learning_rate * grad)


def bucketize(value, minimum: float, maximum: float,
              buckets: int) -> jnp.ndarray:
    """Map a scalar to its bucket index over [minimum, maximum]."""
    v = jnp.clip(
        (jnp.asarray(value, jnp.float32) - minimum) / (maximum - minimum),
        0.0, 1.0,
    )
    return jnp.round(v * (buckets - 1)).astype(jnp.int32)


def bucket_value(bucket, minimum: float, maximum: float,
                 buckets: int) -> jnp.ndarray:
    """Center value of a bucket (inverse of `bucketize`)."""
    return minimum + bucket.astype(jnp.float32) / (buckets - 1) * (
        maximum - minimum
    )
