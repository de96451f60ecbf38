"""The tiny sizes the CPU tests run the benchmark's cells at: the port's
tiny model configuration under each entry, 6-frame 72×128 templates."""

import json
from pathlib import Path

from mimo_tpu_torch.config import tiny_mimo_config, to_dict


def config(entry: str) -> dict:
    cfg = to_dict(tiny_mimo_config())
    cfg.update(entry=entry, dtype="float32")
    cfg["pipeline"].update(width=64, height=64, num_inference_steps=2,
                           context_frames=4, context_overlap=1)
    return cfg


def config_file(entry: str, directory: Path) -> Path:
    path = directory / f"tiny-{entry}.json"
    path.write_text(json.dumps(config(entry)))
    return path


def traffic(entry: str, frames: int = 6) -> dict:
    streams = ["sdc"] if entry == "animate" else ["sdc", "vid", "bk", "occ"]
    return {"frames": frames, "height": 72, "width": 128, "streams": streams,
            "speed": [0.3, 0.6], "ref_size": [96, 64], "occ_size": [10, 14],
            "max_clips": 3}


CELLS = {"animate": "animate-24f-512x784", "edit": "edit-24f-784"}
