"""Training of the image classifiers (MobileNetV2, the ViT family): ``python -m tpunet_torch.train`` (see
``__main__``), the ``Trainer`` (``loop``), the steps, the optimizer
stack and the metric sums. Data parallelism launches the CLI once per
rank:

    torchrun --standalone --nproc-per-node N -m tpunet_torch.train \\
        --preset distributed ...
"""
