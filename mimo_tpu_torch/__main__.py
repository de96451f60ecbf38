"""Top-level CLI dispatcher of the PyTorch port:
python -m mimo_tpu_torch <command> ...

  animate   character image animation from an sdc template
  edit      video character replacement with full compositing
  serve     gradio web app (if gradio is installed)
  decomp    in-the-wild video -> template extraction (track, pose,
            motion, bk and occ ported, not the command yet)
  bench     headline benchmark (not ported yet)

animate and edit run on a CUDA device.
"""

import sys

NOT_PORTED = {
    "decomp": "decomposition is ported up to its occlusion stage "
              "(mimo_tpu_torch.decomp: get_first_mask, get_human, get_bbox, "
              "estimate_pose_batch, get_motion, get_bk_recover, get_occ; "
              "profile them with `python -m "
              "mimo_tpu_torch.tools.profile_decomp --stages "
              "track,pose,motion,bk,occ`); the command's `run` (stage 7, "
              "with video I/O) is not ported yet (ROADMAP.md, Queue 1 item "
              "2); use `python -m mimo_tpu decomp`",
    "bench": "the benchmark is not ported yet (ROADMAP.md, Queue 1 item 1: "
             "bench.py imports jax); use `python bench.py` with JAX",
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    cmd, rest = argv[0], argv[1:]
    if cmd == "animate":
        from mimo_tpu_torch.entry.animate import main as m
    elif cmd == "edit":
        from mimo_tpu_torch.entry.edit import main as m
    elif cmd == "serve":
        from mimo_tpu_torch.serving.app import main as m
    elif cmd in NOT_PORTED:
        print(f"{cmd}: {NOT_PORTED[cmd]}", file=sys.stderr)
        raise SystemExit(2)
    else:
        print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
        raise SystemExit(2)
    m(rest)


if __name__ == "__main__":
    main()
