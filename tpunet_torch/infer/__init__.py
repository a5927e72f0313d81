"""Classifier inference: the top-k ``Predictor`` and the Gradio app."""

from tpunet_torch.infer.predict import Predictor, PredictionResult  # noqa: F401
