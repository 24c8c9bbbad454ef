"""utils/tfevents.py, the port's stdlib TensorBoard event writer, and the
Trainer's mirror into it (trainer.tensorboard), against tensorboard's own
reader and tensorboardX's writer (installed here; the port imports
neither).

- CRC32C against published test vectors (RFC 3720 B.4) and tensorboard's
  masked_crc32c; TFRecord framing read back by tensorboard's raw reader.
- The same scalars and panels written by EventWriter and by tensorboardX's
  SummaryWriter (as the JAX ScalarWriter and ImageWriter call it) read back
  by tensorboard's record reader and Event proto (and counted by its
  EventFileLoader): the same file_version, tags, steps and values, images
  of the same size and colorspace that decode to the same pixels.
- ScalarWriter and ImageWriter with tensorboard=True mirror "{mode}/{k}"
  and "{mode}/{panel}" beside scalars.jsonl and the PNG; without it, no tb
  directory."""
import io
import struct

import numpy as np
import pytest
from PIL import Image
from tensorboard.backend.event_processing.event_file_loader import (EventFileLoader,
                                                                    RawEventFileLoader)
from tensorboard.compat.proto import event_pb2
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c as tb_masked
from tensorboardX import SummaryWriter

from mvsformerplusplus_tpu_torch.utils import tfevents
from mvsformerplusplus_tpu_torch.utils.logging import ImageWriter, ScalarWriter


@pytest.mark.parametrize("data,crc", [
    (b"", 0x00000000),
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
])
def test_crc32c_vectors(data, crc):
    assert tfevents.crc32c(data) == crc
    assert tfevents.masked_crc32c(data) == tb_masked(data)


def test_records_read_back_raw(tmp_path):
    payloads = [b"", b"x", bytes(range(256)) * 40]
    path = tmp_path / "events.out.tfevents.0.host"
    path.write_bytes(b"".join(tfevents.record(p) for p in payloads))
    assert list(RawEventFileLoader(str(path)).Load()) == payloads
    first = tfevents.record(b"abc")
    assert struct.unpack("<Q", first[:8])[0] == 3 and len(first) == 8 + 4 + 3 + 4


SCALARS = [("train", {"loss": 1.25, "stage1_loss": -0.5, "lr": 3e-3}, 0),
           ("train", {"loss": 0.75, "grad_norm": 12.5}, 10),
           ("val", {"mean_error": 0.0311, "thres2mm_error": 0.2}, 10 ** 6)]


def _panels():
    rng = np.random.RandomState(0)
    return [("train/depth_est", rng.randint(0, 256, (24, 40, 3)).astype(np.uint8), 3),
            ("val/confidence", rng.randint(0, 256, (9, 17, 3)).astype(np.uint8), 1234)]


def _read(logdir):
    """The events of the one event file under logdir, as written (raw
    records parsed as Event protos), after checking that TensorBoard's own
    loader (which migrates simple values to tensors) reads as many."""
    files = sorted(logdir.glob("events.out.tfevents.*"))
    assert len(files) == 1, files
    events = [event_pb2.Event.FromString(r) for r in RawEventFileLoader(str(files[0])).Load()]
    assert len(list(EventFileLoader(str(files[0])).Load())) == len(events)
    return events


def _summaries(events):
    out = []
    for e in events:
        for v in e.summary.value:
            if v.HasField("image"):
                img = np.asarray(Image.open(io.BytesIO(v.image.encoded_image_string)))
                out.append((e.step, v.tag, (v.image.height, v.image.width, v.image.colorspace),
                            img))
            else:
                out.append((e.step, v.tag, v.simple_value))
    return out


def test_event_file_matches_tensorboardx(tmp_path):
    ours = tfevents.EventWriter(tmp_path / "ours")
    theirs = SummaryWriter(str(tmp_path / "tbx"))
    for mode, scalars, step in SCALARS:
        for k, v in scalars.items():
            ours.add_scalar(f"{mode}/{k}", v, step)
            theirs.add_scalar(f"{mode}/{k}", v, step)
    for tag, img, step in _panels():
        ours.add_image(tag, img, step)
        theirs.add_image(tag, img, step, dataformats="HWC")
    theirs.close()
    got, want = _read(tmp_path / "ours"), _read(tmp_path / "tbx")
    assert got[0].file_version == want[0].file_version == "brain.Event:2"
    assert len(got) == len(want) == 1 + sum(len(s) for _, s, _ in SCALARS) + len(_panels())
    g, w = _summaries(got[1:]), _summaries(want[1:])
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a[:3] == b[:3], (a[:3], b[:3])
        if len(a) == 4:
            np.testing.assert_array_equal(a[3], b[3])
    assert all(e.wall_time > 0 for e in got)


def test_trainer_writers_mirror_into_tb(tmp_path):
    scalars = ScalarWriter(tmp_path, tensorboard=True)
    images = ImageWriter(tmp_path, tb=scalars.tb)
    scalars.write("train", {"loss": 2.0, "lr": 1e-3}, 5)
    rng = np.random.RandomState(1)
    depth, gt = rng.rand(8, 12) * 100 + 400, rng.rand(8, 12) * 100 + 400
    images.write("val", 5, depth, gt, confidence=rng.rand(8, 12), mask=np.ones((8, 12)))
    summ = _summaries(_read(tmp_path / "tb")[1:])
    assert [s[:3] for s in summ[:2]] == [(5, "train/loss", 2.0),
                                         (5, "train/lr", np.float32(1e-3))]
    assert [(s[1], s[2]) for s in summ[2:]] == [(f"val/{p}", (8, 12, 3)) for p in
                                                ("depth_gt", "depth_est", "abs_error",
                                                 "confidence")]
    png = np.asarray(Image.open(tmp_path / "images" / "val_step00000005.png"))
    np.testing.assert_array_equal(np.concatenate([s[3] for s in summ[2:]], axis=1), png)
    assert (tmp_path / "scalars.jsonl").read_text().count("\n") == 1

    plain = tmp_path / "plain"
    ScalarWriter(plain).write("train", {"loss": 1.0}, 0)
    assert not (plain / "tb").exists() and (plain / "scalars.jsonl").exists()
