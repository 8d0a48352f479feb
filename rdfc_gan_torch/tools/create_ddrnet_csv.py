"""Build the DDRNet-human csv index (port of the repository's
``tools/create_ddrnet_csv.py``; reference
RDF-GAN/lib/dataset/ddrnet_human/createcsv.py): each row is
``color_map,depth_map,high_quality_depth,mask`` absolute paths, one row per
image found under ``<input>/color_map/``, appended to the csv.

Usage: python -m rdfc_gan_torch.tools.create_ddrnet_csv <input_dir> <out.csv>
"""

from __future__ import annotations

import os
import os.path as osp
import sys


def write_index(input_dir: str, output_csv: str) -> int:
    path = osp.abspath(input_dir)
    images = sorted(os.listdir(osp.join(path, "color_map")))
    with open(output_csv, "a") as fout:
        for image in images:
            row = [osp.join(path, sub, image)
                   for sub in ("color_map", "depth_map",
                               "high_quality_depth", "mask")]
            fout.write(",".join(row) + "\n")
    return len(images)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = write_index(argv[0], argv[1])
    print(f"indexed {n} images -> {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
