"""The port's obs command lines, counterparts of the reference's scripts
with the same flags and the same output, run as ``python -m``:

- ``tpunet_torch.obs.cli.compare``   — ``scripts/obs_compare.py``;
- ``tpunet_torch.obs.cli.timeline``  — ``scripts/obs_timeline.py``;
- ``tpunet_torch.obs.cli.dashboard`` — ``scripts/obs_dashboard.py``;
- ``tpunet_torch.obs.cli.report``    — ``scripts/obs_report.py`` (its
  ``--trace`` reads the port's ``torch.profiler`` traces through
  ``tpunet_torch.obs.trace_phase``);
- ``tpunet_torch.obs.cli.crash_report`` — ``scripts/obs_crash_report.py``
  (over ``tpunet_torch.obs.flightrec.report``).

They import no JAX, so the card's host runs them on a run directory of
the port (or of tpunet: the records are the same).
"""
