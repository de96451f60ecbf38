"""Web serving app: the reference's Gradio UI (app.py:27-467 `WebApp`:
preset template gallery, reference-image upload, run button).

Counterpart of ``mimo_tpu/serving/app.py``. Gradio is import-gated:
``build_app()`` raises a clear error without it, while ``run_process()``
(the serving entry the UI calls) stays importable and testable. The runner
builds on the card unless ``device`` names the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from mimo_tpu_torch.config import DTypePolicy, MIMOConfig
from mimo_tpu_torch.entry import edit as EDIT
from mimo_tpu_torch.entry.runner import Runner, init_random_params, load_params
from mimo_tpu_torch.utils import video_io as VIO


@dataclass
class WebApp:
    template_root: str
    weights_path: Optional[str] = None
    width: int = 784
    height: int = 784
    steps: int = 25
    cfg_scale: float = 3.5
    seed: int = 42
    device: str = "cuda"
    _runner: Optional[Runner] = None

    def templates(self) -> List[str]:
        if not os.path.isdir(self.template_root):
            return []
        return sorted(
            d for d in os.listdir(self.template_root)
            if os.path.exists(os.path.join(self.template_root, d,
                                           "sdc.mp4")))

    def runner(self) -> Runner:
        """The model, built at first use: the bundle at ``weights_path``,
        else random weights from a seeded generator."""
        if self._runner is None:
            dev = torch.device(self.device)
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("WebApp: no CUDA device; pass "
                                   "device='cpu' to serve from the CPU")
            dtype = DTypePolicy.for_device(dev).compute_dtype
            cfg = MIMOConfig()
            if self.weights_path:
                params = load_params(self.weights_path, device=dev,
                                     dtype=dtype)
            else:
                gen = torch.Generator(device=dev).manual_seed(0)
                params = init_random_params(cfg, gen, dtype=dtype)
            self._runner = Runner(cfg=cfg, params=params, device=dev,
                                  dtype=dtype)
        return self._runner

    def run_process(self, ref_image: np.ndarray, template_name: str,
                    out_path: str) -> str:
        """The serving entry (reference app.py:387-409 → MIMO.run)."""
        template = os.path.join(self.template_root, template_name)
        frames = EDIT.edit(self.runner(), ref_image, template,
                           width=self.width, height=self.height,
                           steps=self.steps, cfg_scale=self.cfg_scale,
                           seed=self.seed)
        fps = 30
        cfg_file = os.path.join(template, "config.json")
        if os.path.exists(cfg_file):
            with open(cfg_file) as f:
                fps = json.load(f).get("fps", 30)
        VIO.save_video(frames, out_path, fps=fps)
        return out_path


def build_app(webapp: WebApp):
    """Construct the Gradio Blocks UI (raises if gradio is unavailable)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; use the "
            "mimo_tpu_torch.entry.edit / animate CLIs instead") from e

    names = webapp.templates()

    def _preview(name):
        """Gallery tile: the tracked source if present, else the pose
        video."""
        d = os.path.join(webapp.template_root, name)
        for f in ("vid.mp4", "sdc.mp4"):
            p = os.path.join(d, f)
            if os.path.exists(p):
                return p
        return None

    out_dir = tempfile.mkdtemp(prefix="mimo_serve.")
    with gr.Blocks(title="MIMO") as demo:
        gr.Markdown("# MIMO — controllable character video synthesis")
        with gr.Accordion(label="Guidance", open=True):
            gr.Markdown(
                "- **step 1:** upload a character image\n"
                "- **step 2:** choose a motion template from the gallery\n"
                "- **step 3:** click Run\n"
                "- Note: the character image should be full-body, "
                "front-facing, no occlusion, no handheld objects")
        selected = gr.State(names[0] if names else None)
        with gr.Row():
            ref = gr.Image(label="Input image")
            with gr.Column():
                gallery = gr.Gallery(
                    label="Gallery", columns=2, height=500,
                    value=[(_preview(n), n) for n in names],
                    show_label=True,
                    selected_index=0 if names else None)
                btn = gr.Button("Run", variant="primary")
            out = gr.Video(label="Generated Result", autoplay=True)

        def _select(evt: gr.SelectData):
            return names[evt.index]

        gallery.select(_select, inputs=[], outputs=[selected])

        def _run(img, tpl):
            return webapp.run_process(np.asarray(img), tpl,
                                      os.path.join(out_dir, "out.mp4"))

        btn.click(_run, inputs=[ref, selected], outputs=[out])
    return demo


def main(argv=None):
    ap = argparse.ArgumentParser(description="MIMO web app (PyTorch port)")
    ap.add_argument("--templates", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--port", type=int, default=7860)
    args = ap.parse_args(argv)
    app = WebApp(template_root=args.templates, weights_path=args.weights)
    build_app(app).launch(server_port=args.port)


if __name__ == "__main__":
    main()
