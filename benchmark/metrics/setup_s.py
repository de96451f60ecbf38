"""setup_s: seconds from the process's start until the window opens
(imports, the weights drawn on the card, the traffic's inputs, the kernel
library's load or build, the warm-up generation)."""


def read(rec):
    return rec["setup_s"]
