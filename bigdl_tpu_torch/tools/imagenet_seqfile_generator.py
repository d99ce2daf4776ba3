"""Image folder -> record shards (counterpart of
``bigdl_tpu.tools.imagenet_seqfile_generator``;
models/utils/ImageNetSeqFileGenerator.scala, which packed raw JPEGs into
Hadoop SequenceFiles; here the crc-framed ``.btir`` shards that
``ImageFolderDataSet(record_shards=...)`` reads, written by
:func:`~bigdl_tpu_torch.dataset.imagenet.write_image_record_shards`)::

    python -m bigdl_tpu_torch.tools.imagenet_seqfile_generator \\
        -f IMAGENET/train -o SHARDS -p 64

Prints each shard's path and returns the list.
"""
from __future__ import annotations

import argparse

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Pack an ImageFolder into record shards")
    ap.add_argument("-f", "--folder", required=True,
                    help="class-subfolder image tree (train or val)")
    ap.add_argument("-o", "--output", required=True,
                    help="output directory for shards")
    ap.add_argument("-p", "--parallel", type=int, default=8,
                    help="number of shards (the reference's partition "
                         "count)")
    ap.add_argument("--prefix", default="imagenet")
    args = ap.parse_args(argv)

    from bigdl_tpu_torch.dataset import write_image_record_shards

    shards = write_image_record_shards(
        args.folder, args.output, num_shards=args.parallel,
        prefix=args.prefix)
    for s in shards:
        print(s)
    return shards


if __name__ == "__main__":
    main()
