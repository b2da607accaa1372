"""bithtm_tpu: a batched Hierarchical Temporal Memory framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of cokwa/bitHTM
(SpatialPooler + TemporalMemory + HierarchicalTemporalMemory,
`bithtm/__init__.py:1-6` in the reference): functional state pytrees,
static padded synapse pools, bit-packed overlaps, vmap-batched streams
under lax.scan, and mesh sharding across devices. It runs on NVIDIA
GPUs (and on the CPU for tests).

Two API surfaces:
  * functional: `htm_init` / `htm_step` / `htm_scan` (+ sp_/tm_ variants)
  * object-style convenience wrappers mirroring the reference class names:
    `HierarchicalTemporalMemory`, `SpatialPooler`, `TemporalMemory`.
"""

from .config import (
    HTMConfig,
    SPConfig,
    TMConfig,
    config_from_dict,
    config_to_dict,
    make_htm_config,
    make_tm_config,
)
from .state import (
    HTMState,
    SPState,
    TMState,
    htm_init,
    htm_init_batch,
    sp_init,
    tm_init,
)
from .models.htm import (HTMOutput, htm_scan, htm_scan_autocap,
                         htm_serve_scan, htm_step, htm_step_batch,
                         resume_learning)
from .models.spatial_pooler import SPOutput, sp_step
from .models.temporal_memory import (TMOutput, tm_resume,
                                     tm_segment_observables, tm_step)
from .host_hooks import HostTemporalMemory
from .networks import HierarchicalTemporalMemory, SpatialPooler, TemporalMemory
from .encoders import (
    CategoryEncoder,
    CyclicEncoder,
    DateTimeEncoder,
    ScalarEncoder,
    alert_episodes,
    anomaly_likelihood_init,
    anomaly_likelihood_update,
    anomaly_score,
    score_alert_windows,
    seasonal_zscore,
    seasonal_zscore_init,
    seasonal_zscore_update,
)
from .models.stack import (
    StackConfig,
    StackOutput,
    make_stack_config,
    stack_init,
    stack_scan,
    stack_step,
)
from .readout import (
    ClassifierState,
    bucket_value,
    bucketize,
    classifier_init,
    classifier_predict,
    classifier_update,
)

__all__ = [
    "HTMConfig", "SPConfig", "TMConfig", "make_htm_config", "make_tm_config",
    "HTMState", "SPState", "TMState",
    "htm_init", "htm_init_batch", "sp_init", "tm_init",
    "htm_step", "htm_step_batch", "htm_scan", "htm_scan_autocap",
    "htm_serve_scan", "resume_learning", "HTMOutput",
    "sp_step", "SPOutput", "tm_step", "tm_resume",
    "tm_segment_observables", "TMOutput",
    "HierarchicalTemporalMemory", "SpatialPooler", "TemporalMemory",
    "HostTemporalMemory",
    "ScalarEncoder", "CyclicEncoder", "CategoryEncoder", "DateTimeEncoder",
    "anomaly_likelihood_init",
    "anomaly_likelihood_update",
    "anomaly_score",
    "alert_episodes", "score_alert_windows",
    "seasonal_zscore", "seasonal_zscore_init", "seasonal_zscore_update",
    "ClassifierState", "classifier_init", "classifier_predict",
    "classifier_update", "bucketize", "bucket_value",
    "config_to_dict", "config_from_dict",
    "StackConfig", "StackOutput", "make_stack_config", "stack_init",
    "stack_step", "stack_scan",
]

__version__ = "0.1.0"
