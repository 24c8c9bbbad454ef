"""ORB's rBRIEF table and the ORB fixtures, from the installed OpenCV.

OpenCV's ORB samples its descriptor with a fixed table of 256 point pairs
(`bit_pattern_31_` in modules/features2d/src/orb.cpp, Apache-2.0): 1024
int32 in [-13, 13], which starts 8 -3 9 5 4 2 7 -12 -11 9 -8 2. OpenCV
links it into cv2's shared library as it is, so this script finds it there
by those first values (no fixed offset) and checks it against the copy in
the port's host library (mvsformerplusplus_tpu_torch/csrc/host/orb.cpp,
between its BEGIN/END bit_pattern_31 lines), or writes that copy:

    python tests/data/make_orb_fixtures.py --check-table
    python tests/data/make_orb_fixtures.py --write-table

With no argument it writes the ORB fixtures beside this file, which the
CPU tests and chip_smoke.py (on a machine without OpenCV) hold the port's
ORB to, each image's cv2.ORB_create(nfeatures=4000).detectAndCompute on
cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2GRAY):

- <image>.orb.npy: float32 [N, 6] keypoints, rows (x, y, size, angle,
  response, octave) in cv2's order;
- <image>.orb_desc.npy: uint8 [N, 32] descriptors;

for photo_1152x1536_progressive_q75.jpg and orb_texture_301x419.png (a
blocky texture this script writes with PIL). The committed files were
written with opencv-python 5.0.0 (IPP 2026.0) and PIL 12.1.0.
"""
import argparse
import re
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ORB_CPP = HERE.parents[1] / "mvsformerplusplus_tpu_torch" / "csrc" / "host" / "orb.cpp"
FIRST = (8, -3, 9, 5, 4, 2, 7, -12, -11, 9, -8, 2)
IMAGES = ("photo_1152x1536_progressive_q75.jpg", "orb_texture_301x419.png")
N_FEATURES = 4000


def cv2_table() -> np.ndarray:
    """The 1024 int32 of OpenCV's bit_pattern_31_, found in cv2's binary."""
    import cv2

    lib = max(Path(cv2.__file__).parent.glob("cv2*.so"), key=lambda p: p.stat().st_size)
    data = lib.read_bytes()
    at = data.find(np.array(FIRST, "<i4").tobytes())
    if at < 0:
        raise SystemExit(f"the rBRIEF table's first values are not in {lib}")
    table = np.frombuffer(data[at:at + 4096], "<i4").copy()
    if np.abs(table).max() > 13:
        raise SystemExit(f"values past the table's range at byte {at} of {lib}")
    return table


def port_table() -> np.ndarray:
    text = ORB_CPP.read_text()
    body = re.search(r"// BEGIN bit_pattern_31\n(.*?)// END bit_pattern_31", text, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"-?\d+", body.split("=", 1)[1])], np.int32)


def write_table(table: np.ndarray) -> None:
    rows = [", ".join(f"{v:3d}" for v in table[i:i + 16]) for i in range(0, 1024, 16)]
    body = ("const int kBitPattern31[256 * 4] = {\n" + ",\n".join("    " + r for r in rows)
            + "};\n")
    text = ORB_CPP.read_text()
    text = re.sub(r"(// BEGIN bit_pattern_31\n).*?(// END bit_pattern_31)",
                  lambda m: m.group(1) + body + m.group(2), text, flags=re.S)
    ORB_CPP.write_text(text)


def texture(seed, h, w):
    rng = np.random.RandomState(seed)
    base = np.kron(rng.rand(h // 8 + 2, w // 8 + 2, 3), np.ones((8, 8, 1)))[:h, :w]
    return (base * 200 + rng.rand(h, w, 3) * 55).astype(np.uint8)


def cv2_orb(path: Path):
    import cv2

    gray = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2GRAY)
    kps, desc = cv2.ORB_create(nfeatures=N_FEATURES).detectAndCompute(gray, None)
    rows = np.array([(k.pt[0], k.pt[1], k.size, k.angle, k.response, k.octave) for k in kps],
                    np.float32).reshape(-1, 6)
    return rows, (np.zeros((0, 32), np.uint8) if desc is None else desc)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--check-table", action="store_true")
    p.add_argument("--write-table", action="store_true")
    args = p.parse_args()
    table = cv2_table()
    if args.write_table:
        write_table(table)
    if args.check_table or args.write_table:
        ok = np.array_equal(port_table(), table)
        print("orb.cpp's table equals cv2's" if ok else "orb.cpp's table differs from cv2's")
        sys.exit(0 if ok else 1)
    from PIL import Image

    Image.fromarray(texture(5, 301, 419)).save(HERE / IMAGES[1])
    for name in IMAGES:
        rows, desc = cv2_orb(HERE / name)
        np.save(HERE / f"{name}.orb.npy", rows)
        np.save(HERE / f"{name}.orb_desc.npy", desc)
        print(name, len(rows), "keypoints")


if __name__ == "__main__":
    main()
