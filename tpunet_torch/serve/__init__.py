"""Serving: the micro-batched classifier path (``classify``).

The LM serving engine of ``tpunet/serve`` is ROADMAP Queue A item 5.
"""

from tpunet_torch.serve.classify import ClassifyBatcher  # noqa: F401
