"""The seeded training data of a cell: images, labels and the zip the
recipe's loader reads.

``images(seed, n, resolution)`` makes ``n`` uint8 HWC images: an 8 x 8 grid
of colours upsampled to the resolution (smooth fields, as photographs have)
plus a little noise, cut at a seeded offset from one noise field.
``labels(seed, n, classes)`` gives every class the same number of images,
up to one, in a seeded order.  Both are functions of
their arguments alone, so the reference makes the same data without reading
the zip.

``write_zip`` writes them in the ``dataset_tool`` layout the program's
``image_folder`` dataset reads (a copy of the writer of
style_big_gan_tpu_torch/tools/dataset_tool.py): uncompressed PNGs named
``{i // 1000:05d}/img{i:08d}.png`` in a stored zip, and ``dataset.json``
with ``{"labels": [[name, class], ...]}`` (``null`` without labels).  Every
entry has a fixed time stamp, so a seed gives the same bytes every time.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Optional

import numpy as np

_STAMP = (2020, 1, 1, 0, 0, 0)


def image_name(i: int) -> str:
    return f"{i // 1000:05d}/img{i:08d}.png"


def images(seed: int, n: int, resolution: int) -> np.ndarray:
    """[n, resolution, resolution, 3] uint8."""
    rnd = np.random.RandomState(seed % (2 ** 32))
    grid = rnd.uniform(0, 255, size=(n, 8, 8, 3)).astype(np.float32)
    rep = max(1, resolution // 8)
    smooth = grid.repeat(rep, axis=1).repeat(rep, axis=2)
    smooth = smooth[:, :resolution, :resolution]
    field = rnd.normal(0, 12, size=(2 * resolution, 2 * resolution, 3))
    field = field.astype(np.float32)
    out = np.empty(smooth.shape, np.uint8)
    for i, (y, x) in enumerate(rnd.randint(0, resolution, size=(n, 2))):
        cut = field[y:y + resolution, x:x + resolution]
        np.clip(smooth[i] + cut, 0, 255, out=smooth[i])
        out[i] = smooth[i]
    return out


def labels(seed: int, n: int, classes: int) -> Optional[np.ndarray]:
    """[n] int64 classes, each class n // classes or one more times."""
    if classes <= 0:
        return None
    order = np.arange(n) % classes
    np.random.RandomState((seed + 1) % (2 ** 32)).shuffle(order)
    return order.astype(np.int64)


def write_zip(path: str, imgs: np.ndarray,
              labs: Optional[np.ndarray]) -> int:
    """Write the dataset zip; returns its size in bytes."""
    import PIL.Image
    entries = []
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as zf:
        for i, img in enumerate(imgs):
            buf = io.BytesIO()
            PIL.Image.fromarray(img, "RGB").save(buf, format="png",
                                                 compress_level=0)
            zf.writestr(zipfile.ZipInfo(image_name(i), _STAMP),
                        buf.getvalue())
            if labs is not None:
                entries.append([image_name(i), int(labs[i])])
        meta = {"labels": entries if labs is not None else None}
        zf.writestr(zipfile.ZipInfo("dataset.json", _STAMP),
                    json.dumps(meta))
    return os.path.getsize(path)
