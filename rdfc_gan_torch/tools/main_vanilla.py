"""The v1 vanilla-generator driver (port of tools/main_vanilla.py): the
contract of the reference's missing ``RDF-GAN/lib/tools/main_vanilla.py``
(bash/test_nyuv2_Rs2T.sh:4), ``main_v1`` with ``--model vanilla``.

    python -m rdfc_gan_torch.tools.main_vanilla --dataset nyuv2_s2d \\
        --data_root S2D --use_guidance --work_dir W [--device cuda|cpu]
"""

from __future__ import annotations

import sys

from .main_v1 import main as _main


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--model" not in argv:
        argv = ["--model", "vanilla"] + argv
    return _main(argv)


if __name__ == "__main__":
    sys.exit(main())
