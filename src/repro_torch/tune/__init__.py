"""Site-level kernel autotuner (the counterpart of ``repro.tune``).

Closes the loop between the paper's §IV-V dataflow/energy model
(``repro_torch.core.energy``) and the port's kernels: plan-generated
workloads (``workloads``), measured spike sparsity (``sparsity``), an
analytic candidate oracle (``oracle``), a timed top-K sweep on the card
(``autotune``), and persisted tuned-block tables (``table``) that kernel
dispatch consults.

Only the table layer is imported eagerly — it sits on the model dispatch
path (``core/spiking_layers.py``) and must stay import-light; the other
submodules load lazily on first attribute access.
"""
from repro_torch.tune.table import (TunedBlocks, active_table,
                                    current_device_kind, describe_tuned,
                                    load_table, lookup, lookup_tile,
                                    parse_key, reload, save_table, site_key,
                                    table_path)

_LAZY = {
    "SiteWorkload": "workloads", "site_workloads": "workloads",
    "training_mms": "workloads", "TUNABLE_IMPLS": "workloads",
    "kernel_shape_cases": "workloads",
    "SparsityReport": "sparsity", "measure_sparsity": "sparsity",
    "sparsity_report": "sparsity", "PROBE_OVERRIDES": "sparsity",
    "OracleCandidate": "oracle", "oracle_array": "oracle",
    "oracle_rank": "oracle", "oracle_best_dataflow": "oracle",
    "candidate_cycles": "oracle",
    "SiteTuneResult": "autotune", "TuneReport": "autotune",
    "tune": "autotune", "tune_site": "autotune",
    "tune_and_save": "autotune",
}

__all__ = [
    "TunedBlocks", "active_table", "current_device_kind", "describe_tuned",
    "load_table", "lookup", "lookup_tile", "parse_key", "reload",
    "save_table", "site_key", "table_path", *sorted(_LAZY),
]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"repro_torch.tune.{mod}"), name)
