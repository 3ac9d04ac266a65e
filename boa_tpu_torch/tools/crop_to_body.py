"""Crop a CT to the body (or trunc) bounding box via a rough body model.

Counterpart of `boa_tpu/tools/crop_to_body.py` (TotalSegmentator
`bin/crop_to_body.py:17-88`): runs the 6 mm `body` model (fast) through the
port's `predict_image`, thresholds to body (>0) or trunc only (==1), crops
the input with a 3 mm addon and saves the cropped image plus the bbox as a
`_bbox.json` sidecar, so the crop can be undone later.

    python -m boa_tpu_torch.tools.crop_to_body -i ct.nii.gz -o cropped.nii.gz [-t]
    ... -d cpu      # on the host; the default is the card (-d gpu)
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from boa_tpu_torch.device import named_device
from boa_tpu_torch.io import nifti
from boa_tpu_torch.io.nifti import NiftiImage
from boa_tpu_torch.ops import cropping
from boa_tpu_torch.weights.store import ModelStore


def crop_to_body(img: NiftiImage, *, only_trunc: bool = False,
                 store: ModelStore | None = None, fake_predict=None,
                 device=None) -> tuple[NiftiImage, list[list[int]]]:
    """(cropped image, bbox): the library form of the tool, on `device`
    (the card by default)."""
    from boa_tpu_torch.inference.pipeline import predict_image

    store = store or ModelStore()
    rough = predict_image(img, "body", store, fast=True, fake_predict=fake_predict,
                          device=device)
    data = np.asarray(rough.seg.data)
    mask = (data == 1) if only_trunc else (data > 0.5)
    body = NiftiImage(data=mask.astype(np.uint8), affine=rough.seg.affine.copy())
    cropped, bbox = cropping.crop_to_mask(img, body, addon_mm=(3, 3, 3), dtype=np.int32)
    return cropped, [[int(b) for b in ax] for ax in np.asarray(bbox)]


def main(argv=None, *, store=None, fake_predict=None) -> None:
    """The command. `store` and `fake_predict` (the pipeline's test hook)
    are for callers in Python, not on the command line."""
    parser = argparse.ArgumentParser(description="Crop input image to body.")
    parser.add_argument("-i", dest="input", type=Path, required=True,
                        help="CT nifti image")
    parser.add_argument("-o", dest="output", type=Path, required=True,
                        help="Cropped nifti image")
    parser.add_argument("-t", "--only_trunc", action="store_true", default=False,
                        help="Crop to trunc instead of entire body.")
    parser.add_argument("-nr", "--nr_thr_resamp", type=int, default=1)
    parser.add_argument("-ns", "--nr_thr_saving", type=int, default=6)
    parser.add_argument("-d", "--device", default="gpu",
                        help="gpu (the card, default), gpu:N or cpu")
    parser.add_argument("-q", "--quiet", action="store_true", default=False)
    parser.add_argument("-v", "--verbose", action="store_true", default=False)
    args = parser.parse_args(argv)

    device = named_device(args.device)
    img = nifti.load(args.input)
    cropped, bbox = crop_to_body(img, only_trunc=args.only_trunc, store=store,
                                 fake_predict=fake_predict, device=device)
    nifti.save(cropped, args.output)
    sidecar = args.output.with_name(args.output.name.split(".")[0] + "_bbox.json")
    sidecar.write_text(json.dumps({"bbox": bbox, "original_shape": list(img.shape)}))
    if not args.quiet:
        print(f"Saved cropped image to {args.output} (bbox {bbox})")


if __name__ == "__main__":
    main()
