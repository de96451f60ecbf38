"""Top-level CLI dispatcher of the PyTorch port:
python -m mimo_tpu_torch <command> ...

  animate   character image animation from an sdc template
  edit      video character replacement with full compositing
  serve     gradio web app (if gradio is installed)
  decomp    in-the-wild video -> template extraction

animate, edit and decomp run on a CUDA device (decomp --cpu on the
CPU).
"""

import sys


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
    elif cmd == "decomp":
        from mimo_tpu_torch.decomp.factory import main as m
    else:
        print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
        raise SystemExit(2)
    m(rest)


if __name__ == "__main__":
    main()
