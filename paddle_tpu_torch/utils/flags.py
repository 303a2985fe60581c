"""The runtime flag registry — the port's copy of
``paddle_tpu/utils/flags.py`` (the reference's ``get_flags`` /
``set_flags``, ``paddle/fluid/platform/flags.cc``).

Every flag of the reference is defined here with its name, default and
type, so that :func:`set_flags` takes what the reference takes and an
unknown name raises ``KeyError`` in both.  A flag is read from the
environment once, when it is defined (at import): ``FLAGS_x=1 python
...`` sets it, and a later change of ``os.environ`` does not; set it at
run time with :func:`set_flags`.

The port reads ``FLAGS_fused_optimizer`` (the optimizers' fused update),
``FLAGS_prefetch_to_device`` (``Model.fit``'s input stage),
``FLAGS_program_remat`` with ``FLAGS_remat_budget_mb`` (``Model``'s
budget remat), ``FLAGS_anomaly_action`` (``Model.fit``'s guard),
``FLAGS_check_nan_inf`` (``Model.train_batch``'s loss check),
``FLAGS_chaos_spec`` and ``FLAGS_chaos_seed`` (``utils/chaos.py``),
``FLAGS_flight_recorder`` and ``FLAGS_flight_recorder_capacity``
(``profiler/flight.py``).  Each other flag's doc string names
the ``ROADMAP.md`` item whose module will read it.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List

__all__ = ["define_flag", "get_flag", "set_flags", "get_flags", "all_flags",
           "on_change"]

_lock = threading.Lock()
_FLAGS: Dict[str, Any] = {}
_DOC: Dict[str, str] = {}
_observers: List[Callable[[], None]] = []


def _env_cast(raw: str, default):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def define_flag(name: str, default, doc: str = "") -> None:
    """Define ``name`` with ``default``, or its environment value cast to
    the default's type when the environment holds it."""
    with _lock:
        raw = os.environ.get(name)
        _FLAGS[name] = _env_cast(raw, default) if raw is not None else default
        _DOC[name] = doc


def get_flag(name: str):
    try:
        return _FLAGS[name]
    except KeyError:
        raise KeyError(f"unknown flag '{name}'") from None


def set_flags(flags: Dict[str, Any]) -> None:
    """Set each flag of ``flags``; an unknown name raises ``KeyError``
    (the flags before it stay set, as in the reference)."""
    with _lock:
        for k, v in flags.items():
            if k not in _FLAGS:
                raise KeyError(f"unknown flag '{k}'")
            _FLAGS[k] = v
    for fn in _observers:
        fn()


def on_change(fn: Callable[[], None]) -> None:
    """Call ``fn()`` after every :func:`set_flags`."""
    _observers.append(fn)


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {n: get_flag(n) for n in names}


def all_flags() -> Dict[str, Any]:
    return dict(_FLAGS)


# -- the flags the port reads ------------------------------------------------
define_flag("FLAGS_fused_optimizer", True,
            "optimizer/fused_update.py: every optimizer's step as one "
            "multi-tensor kernel launch per group of parameters; off, the "
            "per-parameter _update path")
define_flag("FLAGS_prefetch_to_device", 2,
            "hapi/model.py: Model.fit's device-prefetch depth (batches kept "
            "on the device by io.DevicePrefetcher's thread); 0 turns the "
            "stage off; DataLoader(prefetch_to_device=N) overrides it")
define_flag("FLAGS_program_remat", False,
            "hapi/model.py: with FLAGS_remat_budget_mb > 0, Model's captured "
            "train step keeps the products and recomputes the rest in the "
            "backward (hapi/remat.py); the Program pass waits for "
            "ROADMAP.md A7")
define_flag("FLAGS_remat_budget_mb", 0,
            "hapi/model.py: the peak-memory budget (MiB) of "
            "FLAGS_program_remat; 0 turns the remat off.  The port has no "
            "planner yet (ROADMAP.md A7), so any budget engages it")
define_flag("FLAGS_anomaly_action", "",
            "hapi/model.py: Model.fit's guard on a nan/inf loss ('', "
            "'raise', 'skip', 'rollback'); set, fit reads the loss after "
            "every step")

# -- defined for set_flags, read by a module still to port -------------------
define_flag("FLAGS_eager_jit_cache", True,
            "the eager core's per-op cache (ROADMAP.md A2)")
define_flag("FLAGS_use_pallas", True,
            "the eager core's kernel dispatch (ROADMAP.md A2); the port's "
            "entry points always run its hand-written kernels")
define_flag("FLAGS_check_nan_inf", False,
            "hapi/model.py: Model.train_batch's captured step reads its "
            "loss and raises on a nan/inf; the eager core's per-op check "
            "waits for ROADMAP.md A2")
define_flag("FLAGS_allocator_strategy", "auto_growth",
            "kept for the API, as in the reference: the caching allocator "
            "owns device memory")
define_flag("FLAGS_benchmark", False,
            "the eager core's per-op synchronisation (ROADMAP.md A2)")
define_flag("FLAGS_cudnn_deterministic", False,
            "the conv leg's cuDNN algorithms (ROADMAP.md A6)")
define_flag("FLAGS_max_inplace_grad_add", 0,
            "kept for the API, as in the reference")
define_flag("FLAGS_init_allocated_mem", False,
            "kept for the API, as in the reference")
define_flag("FLAGS_default_dtype", "float32",
            "the eager core's default floating type (ROADMAP.md A2)")
define_flag("FLAGS_matmul_precision", "default",
            "the eager core's matmul precision (ROADMAP.md A2)")
define_flag("FLAGS_log_recompile", False,
            "the static Executor's recompile notices (ROADMAP.md A7)")
define_flag("FLAGS_check_program", False,
            "the static Executor's verification passes (ROADMAP.md A7)")
define_flag("FLAGS_program_dce", True,
            "the static graph's dead-op pass (ROADMAP.md A7)")
define_flag("FLAGS_program_opt", True,
            "the static graph's optimizing passes (ROADMAP.md A7)")
define_flag("FLAGS_program_opt_skip", "",
            "optimizing passes to skip (ROADMAP.md A7)")
define_flag("FLAGS_aot_store_max_mb", 2048,
            "the artifact store's size cap (ROADMAP.md A8)")
define_flag("FLAGS_host_tracer_capacity", 1 << 20,
            "the profiler's host span ring (ROADMAP.md A8)")
define_flag("FLAGS_chaos_spec", "",
            "utils/chaos.py: the fault-injection schedule")
define_flag("FLAGS_chaos_seed", 0,
            "utils/chaos.py: the fault-injection seed")
define_flag("FLAGS_watchdog_timeout", 60.0,
            "the supervised launch's hang timeout (ROADMAP.md A5)")
define_flag("FLAGS_inference_retrace_warn", 8,
            "the Predictor's retrace warning (ROADMAP.md A6)")
define_flag("FLAGS_serving_queue_depth", 128,
            "the serving engines' default admission bound (ROADMAP.md A4)")
define_flag("FLAGS_compile_cache_dir", "",
            "the persistent compilation cache (ROADMAP.md A8)")
define_flag("FLAGS_lock_san", 0,
            "the lock sanitizer's level (utils/concurrency.py, ROADMAP.md "
            "A8)")
define_flag("FLAGS_lock_hold_warn_ms", 200.0,
            "the lock sanitizer's long-hold warning (ROADMAP.md A8)")
define_flag("FLAGS_straggler_factor", 3.0,
            "the supervised launch's straggler detection (ROADMAP.md A5)")
define_flag("FLAGS_straggler_patience", 3,
            "the supervised launch's straggler strikes (ROADMAP.md A5)")
define_flag("FLAGS_fused_conv", True,
            "the fused conv + batch norm + activation (ROADMAP.md A6)")
define_flag("FLAGS_conv_bn_fold", False,
            "the static graph's conv/batch-norm fold (ROADMAP.md A7)")
define_flag("FLAGS_kv_cache_dtype", "float32",
            "the paged KV cache's storage type (ROADMAP.md A4)")
define_flag("FLAGS_prefix_cache_blocks", 0,
            "the prefix cache's capacity (ROADMAP.md A4)")
define_flag("FLAGS_speculative_k", 0,
            "speculative decoding's draft tokens (ROADMAP.md A4)")
define_flag("FLAGS_request_trace", False,
            "per-request serving traces (ROADMAP.md A4)")
define_flag("FLAGS_mem_accounting", False,
            "device-memory accounting, memscope (ROADMAP.md A8)")
define_flag("FLAGS_flight_recorder", True,
            "profiler/flight.py: the flight recorder's event ring")
define_flag("FLAGS_flight_recorder_capacity", 2048,
            "profiler/flight.py: the flight recorder's ring size")
