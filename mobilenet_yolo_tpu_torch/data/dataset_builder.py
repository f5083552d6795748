"""Offline dataset builder: VOC XML / COCO JSON -> record shards (port of
``mobilenet_yolo_tpu/data/dataset_builder.py``, a copy writing through the
port's ``RecordWriter``).

The ETL counterpart of reference folder2lmdb.py:272-360 +
data/od_dataset_from_file.py, with the identical yaml contract: the data
yaml names image/annotation/segmentation dirs, imageset lists and output
shard directories (the ``lmdb`` keys). Annotations become normalized yolo
``(label, cx, cy, w, h)`` rows with 1-indexed labels (background=0);
images are re-encoded JPEG q98, segmentation maps PNG
(od_dataset_from_file.py:95-99).
"""

from __future__ import annotations

import glob
import json
import os
import xml.etree.ElementTree as ET

import numpy as np

from mobilenet_yolo_tpu_torch.data.records import RecordWriter


def parse_voc_xml(path: str, classes_map: dict[str, int]):
    """VOC annotation -> (boxes, labels, difficulties)
    (od_dataset_from_file.py:179-200; pixel corners, '-1' origin shift)."""
    boxes, labels, difficulties = [], [], []
    tree = ET.parse(path)
    for obj in tree.getroot().iter("object"):
        diff_node = obj.find("difficult")
        difficult = int(diff_node is not None and diff_node.text == "1")
        label = obj.find("name").text.lower().strip()
        if label not in classes_map:
            continue
        bb = obj.find("bndbox")
        boxes.append([int(float(bb.find(k).text)) - 1
                      for k in ("xmin", "ymin", "xmax", "ymax")])
        labels.append(classes_map[label])
        difficulties.append(difficult)
    return boxes, labels, difficulties


def parse_coco_json(path: str, classes: list[str], ori_classes: list[str]):
    """Per-image COCO-style json -> (boxes, labels, difficulties)
    (od_dataset_from_file.py:202-229: xywh->corners, class remap, clamping)."""
    with open(path) as f:
        data = json.load(f)
    width = int(data["image"]["width"]) - 1
    height = int(data["image"]["height"]) - 1
    boxes, labels, difficulties = [], [], []
    for ann in data["annotation"]:
        class_id = int(ann["category_id"]) - 1
        name = ori_classes[class_id]
        if name not in classes:
            continue
        new_id = classes.index(name)
        x, y, w, h = [float(v) for v in ann["bbox"]]
        xmin = max(0, int(x + 0.5))
        ymin = max(0, int(y + 0.5))
        xmax = min(width, int(x + w + 0.5))
        ymax = min(height, int(y + h + 0.5))
        boxes.append([xmin, ymin, xmax, ymax])
        labels.append(new_id)
        difficulties.append(0)
    return boxes, labels, difficulties


def to_yolo_labels(boxes, labels, difficulties, width, height,
                   keep_difficult: bool = False) -> np.ndarray:
    """Pixel corners -> normalized (label, cx, cy, w, h, difficult) rows
    (od_dataset_from_file.py:106-131).

    With ``keep_difficult=False`` difficult boxes are dropped, matching the
    reference build (folder2lmdb.py:295-307 passes difficultie=False). With
    True they are kept WITH their flag, so VOC-protocol eval (difficult
    matches neither TP nor FN, eval_mAP.py:8-67) works end-to-end.
    """
    rows = []
    for box, label, diff in zip(boxes, labels, difficulties):
        if not keep_difficult and diff:
            continue
        x = (box[0] + box[2]) / 2 / width
        y = (box[1] + box[3]) / 2 / height
        w = (box[2] - box[0]) / width
        h = (box[3] - box[1]) / height
        rows.append([label, x, y, w, h, float(diff)])
    return np.asarray(rows, np.float32).reshape(-1, 6)


def resolve_items(imgs, annos, lists, ext_img, ext_anno,
                  segs=None, ext_seg=("png",)):
    """Walk imageset lists and resolve (img, anno[, seg]) path tuples
    (od_dataset_from_file.py:133-169)."""
    items = []
    imgs = imgs if isinstance(imgs, list) else [imgs]
    annos = annos if isinstance(annos, list) else [annos]
    lists = lists if isinstance(lists, list) else [lists]
    segs = (segs if isinstance(segs, list) else [segs]) if segs else [None] * len(lists)
    for img_dir, anno_dir, list_file, seg_dir in zip(imgs, annos, lists, segs):
        seg_files = []
        if seg_dir:
            for e in ext_seg:
                seg_files += glob.glob(os.path.join(seg_dir, f"*.{e}"))
        with open(list_file) as f:
            names = [w for line in f for w in line.split()]
        for name in names:
            img_file = _first_existing(img_dir, name, ext_img)
            anno_file = _first_existing(anno_dir, name, ext_anno)
            if img_file is None or anno_file is None:
                continue
            if seg_dir:
                match = next((s for s in seg_files if name in s), None)
                if match is None:
                    continue
                items.append((img_file, anno_file, match))
            else:
                items.append((img_file, anno_file))
    return items


def _first_existing(directory, stem, exts):
    for e in exts:
        p = os.path.join(directory, f"{stem}.{e}")
        if os.path.isfile(p):
            return p
    return None


def _encode_image(path: str, quality: int = 98) -> tuple[bytes, int, int]:
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cannot read image {path}")
    h, w = img.shape[:2]
    ok, buf = cv2.imencode(".jpg", img, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    if not ok:
        raise IOError(f"cannot encode {path}")
    return buf.tobytes(), w, h


def _encode_seg(path: str) -> bytes:
    import cv2
    # IMREAD_UNCHANGED keeps single-channel class-id maps single-channel
    # (the default imread would replicate them to BGR, tripling the shard
    # bytes); palette PNGs still come back BGR-expanded and are rejected
    # at load time by pipeline._decode_seg's replicated-channel assert.
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot read segmentation map {path}")
    ok, buf = cv2.imencode(".png", img, [int(cv2.IMWRITE_PNG_COMPRESSION), 1])
    if not ok:
        raise IOError(f"cannot encode {path}")
    return buf.tobytes()


def build_split(split_cfg: dict, classes: list[str], ori_classes: list[str],
                ext_img, ext_anno, segmentation: bool, ext_seg=("png",),
                keep_difficult: bool = False, log=print) -> str:
    """Build one split's record shard; returns the shard directory."""
    classes_map = {k: v for v, k in enumerate(classes)}
    items = resolve_items(
        split_cfg["imgs"], split_cfg["annos"], split_cfg["lists"],
        ext_img, ext_anno,
        segs=split_cfg.get("segs") if segmentation else None,
        ext_seg=ext_seg,
    )
    out_dir = split_cfg["lmdb"]
    log(f"building {split_cfg.get('name', out_dir)}: {len(items)} items -> {out_dir}")
    total_boxes = 0
    with RecordWriter(out_dir) as w:
        for i, item in enumerate(items):
            img_path, anno_path = item[0], item[1]
            img_bytes, width, height = _encode_image(img_path)
            if anno_path.endswith(".xml"):
                boxes, labels, diffs = parse_voc_xml(anno_path, classes_map)
            else:
                boxes, labels, diffs = parse_coco_json(anno_path, classes[1:],
                                                       ori_classes)
                labels = [l + 1 for l in labels]  # background offset
            rows = to_yolo_labels(boxes, labels, diffs, width, height,
                                  keep_difficult)
            total_boxes += rows.shape[0]
            seg_bytes = _encode_seg(item[2]) if segmentation else None
            w.append_record(img_bytes, rows, seg_bytes)
            if i and i % 5000 == 0:
                log(f"[{i}/{len(items)}]")
        w.close({"classes": classes, "total_boxes": total_boxes,
                 "segmentation": segmentation})
    log(f"total box : {total_boxes}")
    return out_dir


def build_dataset(data_yaml: str, log=print):
    """Full build for a data yaml (reference folder2lmdb.py:272-353)."""
    import yaml
    with open(data_yaml) as f:
        data = yaml.safe_load(f)
    classes = ["background"] + list(data["classes"]["map"])
    ori_classes = list(data["classes"].get("original", data["classes"]["map"]))
    ext_img = data["extention_names"]["image"]
    ext_anno = data["extention_names"]["annotation"]
    segmentation = bool(data.get("segmentation_enable", False))
    ext_seg = data["extention_names"].get("segmentation", ["png"])
    # keep_difficult: false matches the reference build (difficult boxes
    # dropped everywhere, folder2lmdb.py:295-307); true carries them
    # FLAGGED for VOC-protocol evaluation. Train and eval want different
    # answers (train without difficult boxes, eval with them flagged so
    # they match neither TP nor FN), so a per-split mapping
    # ``keep_difficult: {trainval: false, test: true}`` is accepted too —
    # a bare bool applies to both splits for backward compatibility.
    kd = data.get("keep_difficult", False)
    if isinstance(kd, dict):
        kd = {"trainval_dataset_path": bool(kd.get("trainval", False)),
              "test_dataset_path": bool(kd.get("test", True))}
    else:
        kd = {"trainval_dataset_path": bool(kd),
              "test_dataset_path": bool(kd)}
    for split in ("trainval_dataset_path", "test_dataset_path"):
        build_split(data[split], classes, ori_classes, ext_img, ext_anno,
                    segmentation, ext_seg, keep_difficult=kd[split],
                    log=log)
