"""Offline dataset build CLI (port of ``mobilenet_yolo_tpu/cli/build_dataset.py``,
the same flags) — same contract as the reference
``python folder2lmdb.py -d data/voc_data.yaml`` (folder2lmdb.py:356-360):

    python -m mobilenet_yolo_tpu_torch.cli.build_dataset -d <data.yaml> [--preview N]
"""

from __future__ import annotations

import argparse

from mobilenet_yolo_tpu_torch.config import default_data_yaml
from mobilenet_yolo_tpu_torch.data.dataset_builder import build_dataset


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", "--dataset",
                        default=default_data_yaml(),
                        help="path to the data yaml")
    parser.add_argument("--preview", default=0, type=int, metavar="N",
                        help="after building, render N augmented training"
                             " samples with their GT boxes drawn (the"
                             " reference's show_image debug viewer,"
                             " folder2lmdb.py:179-214) into <shard>/preview")
    parser.add_argument("--preview-mosaic", default=1, type=int,
                        help="compose previews from mosaic groups of this"
                             " size (default 1 = plain samples)")
    args = parser.parse_args(argv)
    build_dataset(args.dataset)
    if args.preview > 0:
        import os

        import yaml

        from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset
        from mobilenet_yolo_tpu_torch.data.records import RecordReader
        from mobilenet_yolo_tpu_torch.utils.visualize import dump_pipeline_samples

        with open(args.dataset) as f:
            data = yaml.safe_load(f)
        shard = data["trainval_dataset_path"]["lmdb"]
        classes = ["background"] + list(data["classes"]["map"])
        ds = DetectionDataset(RecordReader(shard), phase="train")
        n = min(args.preview * max(1, args.preview_mosaic), len(ds.reader))
        paths = dump_pipeline_samples(
            ds, list(range(n)), os.path.join(shard, "preview"),
            class_names=classes, mosaic_group=args.preview_mosaic)
        if paths:
            print(f"wrote {len(paths)} GT previews to "
                  f"{os.path.dirname(paths[0])}")
        else:
            print("no GT previews written — the built shard is empty "
                  "(check the imageset lists / extensions in the yaml)")


if __name__ == "__main__":
    main()
