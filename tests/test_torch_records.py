"""The port's record store (``mobilenet_yolo_tpu_torch/data/records.py``) and
dataset builder against the JAX package's, on the CPU.

Mirrors ``tests/test_records.py`` on the port (both readers, v1 records, an
empty record, seg bytes), then holds the two packages to one on-disk
format: shards cross-read in both directions, and the two dataset builders
write byte-identical records and indexes from one fabricated VOC tree. Their
``meta.json`` files differ in the builder's keys (``classes``,
``total_boxes``, ``segmentation``): the port's writer writes it once, so
those keys stay, and the JAX package's rewrites it without them.
"""

import json
import pickle
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from mobilenet_yolo_tpu.data import dataset_builder as j_builder
from mobilenet_yolo_tpu.data import records as j_records
from mobilenet_yolo_tpu_torch.data import dataset_builder, records
from mobilenet_yolo_tpu_torch.data.records import (RecordReader, RecordWriter, decode_record,
                                                   encode_record)

from _torch_parity import assert_builder_meta

REPO = Path(__file__).resolve().parent.parent
LABELS = np.asarray([[1, 0.5, 0.5, 0.2, 0.3], [4, 0.1, 0.2, 0.05, 0.08]], np.float32)


def _write_mixed(d: str, writer_cls) -> None:
    with writer_cls(d) as w:
        w.append_record(b"jpegbytes0", LABELS)
        w.append_record(b"jpegbytes1", LABELS[:1], seg_bytes=b"pngbytes")
        w.append_record(b"", np.zeros((0, 5), np.float32))


def _check_mixed(r) -> None:
    assert len(r) == 3
    rec0 = r[0]
    assert rec0.image_bytes == b"jpegbytes0"
    np.testing.assert_allclose(rec0.labels[:, :5], LABELS)
    np.testing.assert_allclose(rec0.labels[:, 5], 0.0)  # 5-col in -> diff=0
    assert rec0.seg_bytes is None
    assert r[1].image_bytes == b"jpegbytes1" and r[1].seg_bytes == b"pngbytes"
    assert r[2].image_bytes == b"" and r[2].labels.shape == (0, 6)
    assert r.meta["num_records"] == 3


@pytest.mark.parametrize("force_python", [True, False], ids=["python", "native"])
def test_roundtrip(tmp_path, force_python):
    d = str(tmp_path / "shard")
    _write_mixed(d, RecordWriter)
    r = RecordReader(d, force_python=force_python)
    assert (r._lib is None) == force_python
    _check_mixed(r)
    r.close()


def test_native_store_builds_under_build():
    """The port compiles its own copy of the store into ``build/recordstore``
    (keyed by the source's hash), never into ``runtime/``."""
    assert records.route() == "native" and records.native_loaded()
    path = records.library_path()
    assert path.exists() and path.parent == REPO / "build" / "recordstore"
    assert records.SOURCE == REPO / "mobilenet_yolo_tpu_torch" / "csrc" / "recordstore.cc"
    # the same C source as the JAX package's, apart from its header comment
    body = records.SOURCE.read_text().split("#include <cstdint>", 1)[1]
    assert body == (REPO / "runtime" / "recordstore.cc").read_text().split(
        "#include <cstdint>", 1)[1]


def test_native_and_python_agree(tmp_path):
    d = str(tmp_path / "shard")
    rng = np.random.default_rng(0)
    blobs = [rng.bytes(int(rng.integers(0, 5000))) for _ in range(32)]
    with RecordWriter(d) as w:
        for blob in blobs:
            w.append(encode_record(blob, np.zeros((0, 5), np.float32)))
    rn = RecordReader(d, force_python=False)
    rp = RecordReader(d, force_python=True)
    for i in range(32):
        assert rn.get_bytes(i) == rp.get_bytes(i)
        assert decode_record(rn.get_bytes(i)).image_bytes == blobs[i]
    with pytest.raises(IndexError):
        rn.get_bytes(32)


def test_encode_decode_record():
    labels = np.asarray([[2, 0.3, 0.4, 0.1, 0.2]], np.float32)
    rec = decode_record(encode_record(b"abc", labels, b"seg"))
    assert rec.image_bytes == b"abc"
    assert rec.seg_bytes == b"seg"
    np.testing.assert_allclose(rec.labels[:, :5], labels)


def test_encode_decode_difficult_flag():
    labels = np.asarray([[2, 0.3, 0.4, 0.1, 0.2, 1.0],
                         [1, 0.6, 0.6, 0.2, 0.2, 0.0]], np.float32)
    rec = decode_record(encode_record(b"abc", labels))
    np.testing.assert_allclose(rec.labels, labels)


@pytest.mark.parametrize("force_python", [True, False], ids=["python", "native"])
def test_v1_shard_reads_with_zero_difficulty(tmp_path, force_python):
    """5-col v1 records (magic 0x59524543) still read, difficult=0."""
    labels = np.asarray([[2, 0.3, 0.4, 0.1, 0.2]], np.float32)
    d = str(tmp_path / "v1")
    with RecordWriter(d) as w:
        w.append(struct.pack("<IIQQ", 0x59524543, 1, 3, 0) + labels.tobytes() + b"abc")
    rec = RecordReader(d, force_python=force_python)[0]
    assert rec.image_bytes == b"abc" and rec.seg_bytes is None
    assert rec.labels.shape == (1, 6)
    np.testing.assert_allclose(rec.labels[:, :5], labels)
    np.testing.assert_allclose(rec.labels[:, 5], 0.0)


def test_bad_magic_raises():
    with pytest.raises(ValueError):
        decode_record(b"\x00" * 64)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_shards_cross_read(tmp_path, direction):
    """A shard one package writes, the other reads record for record."""
    writer, reader = ((j_records.RecordWriter, RecordReader) if direction == "jax_to_port"
                      else (RecordWriter, j_records.RecordReader))
    d = str(tmp_path / "shard")
    _write_mixed(d, writer)
    for force_python in (True, False):
        _check_mixed(reader(d, force_python=force_python))


def test_record_reader_pickles_across_processes(tmp_path):
    """The native reader's ctypes handles do not cross processes; pickling
    sends (directory, mode) and the reader reopens the shard."""
    import multiprocessing as mp

    d = str(tmp_path / "shard")
    labels = np.asarray([[1, 0.5, 0.5, 0.4, 0.5, 0.0]], np.float32)
    with RecordWriter(d) as w:
        for _ in range(4):
            w.append_record(b"payload", labels)
    r2 = pickle.loads(pickle.dumps(RecordReader(d)))
    assert len(r2) == 4
    np.testing.assert_allclose(r2[1].labels, labels)
    with mp.get_context("spawn").Pool(1) as pool:
        assert pool.apply(_read_len, (RecordReader(d),)) == 4


def _read_len(reader):
    assert reader[0].image_bytes == b"payload"
    return len(reader)


@pytest.fixture(scope="module")
def fabricated_voc(tmp_path_factory):
    """A fabricated VOC tree of 6 trainval and 2 test images
    (``tools/make_fabricated_voc.py``, seed 7), difficult boxes included."""
    root = tmp_path_factory.mktemp("fabvoc")
    subprocess.run([sys.executable, str(REPO / "tools" / "make_fabricated_voc.py"),
                    "--root", str(root), "--train", "6", "--test", "2", "--seed", "7"],
                   check=True, capture_output=True, timeout=120)
    return root


def _yaml_with_shards(root: Path, tag: str) -> str:
    """The tree's data yaml with its shard directories under ``tag``."""
    data = yaml.safe_load((root / "data.yaml").read_text())
    for split in ("trainval_dataset_path", "test_dataset_path"):
        data[split]["lmdb"] = str(root / tag / split)
    path = root / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(data))
    return str(path)


def test_builders_write_identical_shards(fabricated_voc):
    """The JAX and the port's ``build_dataset`` on one tree: ``data.bin``
    and ``index.bin`` byte-identical and ``meta.json`` key for key, but
    for the builder's keys that only the port's keeps
    (``assert_builder_meta``); the port's reader reads the labels back;
    the port's CLI renders ``--preview`` samples with their boxes."""
    j_builder.build_dataset(_yaml_with_shards(fabricated_voc, "jax"), log=lambda *a: None)
    subprocess.run([sys.executable, "-m", "mobilenet_yolo_tpu_torch.cli.build_dataset", "-d",
                    _yaml_with_shards(fabricated_voc, "port"), "--preview", "2"], check=True,
                   cwd=REPO, capture_output=True, timeout=120)
    previews = sorted((fabricated_voc / "port" / "trainval_dataset_path" / "preview").iterdir())
    assert [p.name for p in previews] == ["gt_0.jpg", "gt_1.jpg"]
    classes = ["background"] + list(yaml.safe_load(
        (fabricated_voc / "data.yaml").read_text())["classes"]["map"])
    for split, n in (("trainval_dataset_path", 6), ("test_dataset_path", 2)):
        for name in ("data.bin", "index.bin"):
            want = (fabricated_voc / "jax" / split / name).read_bytes()
            assert (fabricated_voc / "port" / split / name).read_bytes() == want, (split, name)
        assert_builder_meta(fabricated_voc / "port" / split, fabricated_voc / "jax" / split,
                            classes, False)
        r = RecordReader(str(fabricated_voc / "port" / split))
        assert len(r) == n and all(r[i].labels.shape[1] == 6 for i in range(n))
        assert r.meta["num_records"] == n
    # the test split keeps difficult boxes flagged, the trainval split drops them
    trainval = RecordReader(str(fabricated_voc / "port" / "trainval_dataset_path"))
    assert not any(trainval[i].labels[:, 5].any() for i in range(6))


def test_close_writes_meta_once(tmp_path):
    """A second ``close`` (the ``with`` block's, after a builder's
    ``close(meta)``) keeps what the first one wrote."""
    with RecordWriter(str(tmp_path)) as w:
        w.append_record(b"jpegbytes0", LABELS)
        w.close({"classes": ["background", "a"], "total_boxes": 2})
    assert json.loads((tmp_path / "meta.json").read_text()) == {
        "num_records": 1, "format": "recordstore-v1", "classes": ["background", "a"],
        "total_boxes": 2}
    assert len(RecordReader(str(tmp_path))) == 1


def test_to_yolo_labels_and_voc_xml_match_jax(tmp_path):
    xml = tmp_path / "a.xml"
    xml.write_text("<annotation><object><name>Disk </name><difficult>1</difficult><bndbox>"
                   "<xmin>11</xmin><ymin>21</ymin><xmax>51</xmax><ymax>81</ymax></bndbox>"
                   "</object><object><name>cat</name><bndbox><xmin>1</xmin><ymin>1</ymin>"
                   "<xmax>5</xmax><ymax>5</ymax></bndbox></object></annotation>")
    classes_map = {"background": 0, "disk": 1}
    got = dataset_builder.parse_voc_xml(str(xml), classes_map)
    assert got == j_builder.parse_voc_xml(str(xml), classes_map)
    assert got == ([[10, 20, 50, 80]], [1], [1])
    for keep in (False, True):
        np.testing.assert_array_equal(dataset_builder.to_yolo_labels(*got, 100, 90, keep),
                                      j_builder.to_yolo_labels(*got, 100, 90, keep))
