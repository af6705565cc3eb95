"""Pack an image list into a RecordIO file.

The port of ``tools/im2rec.py`` (the reference's tools/im2rec.py /
im2rec.cc), with the same flags; run it as ``python -m
mxnet_tpu_torch.tools.im2rec``.  It reads a .lst file
(``index\tlabel[\tlabel...]\tpath``), encodes each image with the
image-record header, writes ``prefix.rec`` (+ ``prefix.idx`` with
--pack-index) in the dmlc RecordIO wire format that
``mxnet_tpu_torch.io.ImageRecordIter`` (and the JAX package's) consumes.

Image decoding needs PIL; with --raw the file bytes pass through
unmodified (pre-encoded JPEG), which needs no image library at all;
--pack-raw C H W stores center-cropped raw uint8 CHW pixels, the
iterator's decode-free route.
"""
import argparse
import os
import random

from .. import recordio


def read_list(path):
    with open(path) as fin:
        for line in fin:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(parts[0])
            labels = [float(x) for x in parts[1:-1]]
            yield idx, labels, parts[-1]


def make_list(args):
    """--make-list mode: scan an image directory into train/val .lst files
    (parity im2rec.py list generation)."""
    exts = (".jpg", ".jpeg", ".png")
    classes = sorted(d for d in os.listdir(args.root)
                     if os.path.isdir(os.path.join(args.root, d)))
    entries = []
    for li, cls in enumerate(classes):
        for fn in sorted(os.listdir(os.path.join(args.root, cls))):
            if fn.lower().endswith(exts):
                entries.append((li, os.path.join(cls, fn)))
    random.Random(args.seed).shuffle(entries)
    n_val = int(len(entries) * args.val_ratio)
    chunks = [("val", entries[:n_val]), ("train", entries[n_val:])]
    for tag, rows in chunks:
        if not rows:
            continue
        out = "%s_%s.lst" % (args.prefix, tag)
        with open(out, "w") as fo:
            for i, (label, rel) in enumerate(rows):
                fo.write("%d\t%d\t%s\n" % (i, label, rel))
        print("wrote %s (%d entries)" % (out, len(rows)))


def pack(args):
    writer = recordio.MXIndexedRecordIO(args.prefix + ".idx",
                                        args.prefix + ".rec", "w") \
        if args.pack_index else recordio.MXRecordIO(args.prefix + ".rec",
                                                    "w")
    n = 0
    for idx, labels, rel in read_list(args.list):
        path = os.path.join(args.root, rel)
        with open(path, "rb") as f:
            img_bytes = f.read()
        if args.pack_raw:
            # decode + center-crop to --pack-raw CxHxW and store raw uint8
            # CHW pixels: ImageRecordIter's zero-decode fast path (the way
            # to feed a TPU from a host with few/slow cores)
            try:
                from PIL import Image
                import io as _io
                import numpy as np
            except ImportError:
                raise SystemExit("PIL required for --pack-raw")
            c, th, tw = args.pack_raw
            im = Image.open(_io.BytesIO(img_bytes))
            im = im.convert("L" if c == 1 else "RGB")
            w, h = im.size
            if w < tw or h < th:
                s = max(tw / w, th / h)
                im = im.resize((max(tw, int(w * s + 0.5)),
                                max(th, int(h * s + 0.5))))
                w, h = im.size
            x0, y0 = (w - tw) // 2, (h - th) // 2
            arr = np.asarray(im.crop((x0, y0, x0 + tw, y0 + th)),
                             dtype=np.uint8)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            img_bytes = arr.transpose(2, 0, 1).tobytes()   # HWC -> CHW
        elif not args.raw:
            try:
                from PIL import Image
                import io as _io
                import numpy as np
                im = Image.open(_io.BytesIO(img_bytes)).convert("RGB")
                if args.resize:
                    w, h = im.size
                    s = args.resize / min(w, h)
                    im = im.resize((int(w * s), int(h * s)))
                buf = _io.BytesIO()
                im.save(buf, format="JPEG", quality=args.quality)
                img_bytes = buf.getvalue()
            except ImportError:
                raise SystemExit("PIL not available: use --raw to pack "
                                 "pre-encoded bytes unmodified")
        header = recordio.IRHeader(flag=0, label=labels[0] if
                                   len(labels) == 1 else labels,
                                   id=idx, id2=0)
        packed = recordio.pack(header, img_bytes)
        if args.pack_index:
            writer.write_idx(idx, packed)
        else:
            writer.write(packed)
        n += 1
    writer.close()
    print("packed %d records into %s.rec" % (n, args.prefix))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("prefix", help="output prefix")
    parser.add_argument("root", help="image root dir")
    parser.add_argument("--list", type=str, default=None,
                        help=".lst file (required unless --make-list)")
    parser.add_argument("--make-list", action="store_true")
    parser.add_argument("--val-ratio", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resize", type=int, default=0)
    parser.add_argument("--quality", type=int, default=95)
    parser.add_argument("--raw", action="store_true",
                        help="pass file bytes through unmodified")
    parser.add_argument("--pack-raw", type=int, nargs=3, default=None,
                        metavar=("C", "H", "W"),
                        help="store raw uint8 CHW pixels center-cropped to "
                             "CxHxW (ImageRecordIter zero-decode fast path)")
    parser.add_argument("--pack-index", action="store_true",
                        help="also write prefix.idx for random access")
    args = parser.parse_args()
    if args.make_list:
        make_list(args)
    else:
        if not args.list:
            raise SystemExit("--list required (or --make-list)")
        pack(args)


if __name__ == "__main__":
    main()
