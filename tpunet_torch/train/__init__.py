"""MobileNetV2 training: ``python -m tpunet_torch.train`` (see
``__main__``), the ``Trainer`` (``loop``), the steps, the optimizer
stack and the metric sums."""
