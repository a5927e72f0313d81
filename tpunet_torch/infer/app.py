"""Web serving app (Gradio) for the classifier, port of ``tpunet/infer/app.py``.

Image input -> top-3 label output on 0.0.0.0:7861, as the reference
project's app. Preprocessing reuses the training normalization stats.
Gradio is optional: it is imported only when the interface is built,
so :func:`make_classify` is usable and testable without it.
"""

from __future__ import annotations

from typing import Optional

from tpunet_torch.config import ModelConfig
from tpunet_torch.infer.predict import Predictor, add_model_args, model_config


def make_classify(predictor: Predictor):
    """The serving function the web UI calls: PIL image (or None) ->
    {class name: probability}, the input format of ``gr.Label``."""

    def classify(img):
        if img is None:
            return {}
        probs = predictor.predict_probs(img)
        return {name: float(p)
                for name, p in zip(predictor.class_names, probs)}

    return classify


def build_interface(predictor: Optional[Predictor] = None,
                    checkpoint: Optional[str] = None, device: str = "cuda",
                    model_cfg: Optional[ModelConfig] = None):
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; install it to serve the web app, or "
            "use tpunet_torch.infer.predict.Predictor directly") from e

    predictor = predictor or Predictor(model_cfg, checkpoint=checkpoint,
                                       device=device)
    return gr.Interface(
        fn=make_classify(predictor),
        inputs=gr.Image(type="pil", label="Input image"),
        outputs=gr.Label(num_top_classes=3, label="Prediction"),
        title=f"tpunet CIFAR-10 classifier ({predictor.model_cfg.name} "
              "on CUDA)",
        description="Top-3 classes with confidences.",
    )


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="tpunet_torch web serving app")
    p.add_argument("--checkpoint", required=True,
                   help=".pth in the port's layout (a trainer's best.pth)")
    add_model_args(p)
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7861)  # reference port
    args = p.parse_args(argv)
    demo = build_interface(checkpoint=args.checkpoint, device=args.device,
                           model_cfg=model_config(args))
    demo.launch(server_name=args.host, server_port=args.port)


if __name__ == "__main__":
    main()
