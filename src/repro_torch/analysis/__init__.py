"""``repro_torch.analysis`` — the port's static analysis and runtime guard,
the counterpart of ``repro.analysis``.

Static side (pure stdlib, no torch import):

* :mod:`repro_torch.analysis.engine` — visitor framework, rule registry,
  the captured set (code a CUDA graph captures), inline
  ``# repro: allow[rule-id]`` suppressions, finding fingerprints;
* :mod:`repro_torch.analysis.rules` — seven rules, one for each rule of
  ``repro.analysis.rules``, guarding the same invariants in the port;
* :mod:`repro_torch.analysis.baseline` — grandfather file
  (``.repro-torch-analysis-baseline.json``), fail-on-new workflow;
* ``python -m repro_torch.analysis`` — the CLI (text/JSON output,
  ``--strict``).

Runtime side (imports torch; not imported here):

* :mod:`repro_torch.analysis.runtime` — the sync guard (``sync_free``,
  ``guarded``), the explicit drain (``device_get``) and the capture
  sentinel;
* :mod:`repro_torch.analysis.pytest_plugin` — the ``torch_sync_free`` and
  ``torch_runtime_guard`` markers and the ``torch_runtime_guard`` fixture.
"""
from repro_torch.analysis.engine import (Finding, ModuleIndex,  # noqa: F401
                                         ProjectContext, Rule, all_rules,
                                         register_rule, run_paths)
from repro_torch.analysis.baseline import (DEFAULT_BASELINE,  # noqa: F401
                                           load_baseline, split_by_baseline,
                                           write_baseline)

__all__ = [
    "Finding", "ModuleIndex", "ProjectContext", "Rule", "all_rules",
    "register_rule", "run_paths", "DEFAULT_BASELINE", "load_baseline",
    "split_by_baseline", "write_baseline",
]
