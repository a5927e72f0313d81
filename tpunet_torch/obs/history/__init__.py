"""Run history of the port: the config fingerprint that joins runs of
one workload (docs/metrics_schema.md "Run identity"). The JAX package's
history store, regression compare and timeline read the records the
port writes; the port carries only the fingerprint that stamps them.
"""

from __future__ import annotations

from tpunet_torch.obs.history.fingerprint import (config_fingerprint,
                                                  train_fingerprint)

__all__ = ["config_fingerprint", "train_fingerprint"]
