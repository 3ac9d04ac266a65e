"""Pure-Python DICOM codec (no pydicom/GDCM dependency).

Counterpart of `boa_tpu/io/dicom.py`. Parity targets: the pydicom/SimpleITK
usage in `body_organ_analysis/compute/io.py` (series read, tag access, UID
generation, dataset writing) — re-implemented from the DICOM standard
(PS3.5 encoding, PS3.6 data dictionary, PS3.10 file format) because
pydicom is not in the image.

Supports: explicit & implicit VR little endian parsing, sequences
(defined and undefined length), uncompressed pixel data, encapsulated
pixel data with in-repo codecs for JPEG Lossless SV1/P14, JPEG-LS, RLE,
JPEG 2000 and lossy JPEG (io/dicom_codecs.py on the port's C++ decoders
in native/ — the syntaxes GDCM decodes for the reference), file-meta
handling, explicit-VR-LE and encapsulated writing, and pydicom-compatible
deterministic UID generation. Other compressed transfer syntaxes raise a
clear error.
"""

from __future__ import annotations

import hashlib
import math
import os
import secrets
import struct
from pathlib import Path
from typing import Any, Iterator

import numpy as np

# transfer syntaxes
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"
UNCOMPRESSED = {IMPLICIT_VR_LE, EXPLICIT_VR_LE}
# encapsulated syntaxes with in-repo codecs (io/dicom_codecs.py):
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR_LOSSLESS = "1.2.840.10008.1.2.4.81"
JPEG_2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG_2000 = "1.2.840.10008.1.2.4.91"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
SUPPORTED_COMPRESSED = {JPEG_BASELINE, JPEG_EXTENDED,
                        JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1,
                        JPEG_LS_LOSSLESS, JPEG_LS_NEAR_LOSSLESS,
                        JPEG_2000_LOSSLESS, JPEG_2000,
                        RLE_LOSSLESS}


class EncapsulatedFrames:
    """Raw fragments of encapsulated (compressed) PixelData.

    `fragments[0]` is the Basic Offset Table item (possibly empty); the
    rest are the frame fragments in stream order.
    """

    __slots__ = ("fragments",)

    def __init__(self, fragments: list[bytes]):
        self.fragments = fragments

    @property
    def offset_table(self) -> list[int]:
        bot = self.fragments[0] if self.fragments else b""
        return list(np.frombuffer(bot, "<u4")) if bot else []

    def frames(self, n_frames: int) -> list[bytes]:
        frags = self.fragments[1:]
        if n_frames == 1:
            return [b"".join(frags)]
        if len(frags) == n_frames:
            return frags
        offsets = self.offset_table
        if len(offsets) == n_frames:
            # offsets index the byte stream of item headers+fragments
            stream_pos = []
            pos = 0
            for fr in frags:
                stream_pos.append(pos)
                pos += 8 + len(fr)
            frames: list[bytes] = []
            for i, start in enumerate(offsets):
                stop = offsets[i + 1] if i + 1 < len(offsets) else pos
                frames.append(b"".join(
                    fr for p, fr in zip(stream_pos, frags)
                    if start <= p < stop))
            return frames
        raise ValueError(
            f"cannot split {len(frags)} fragments into {n_frames} frames "
            "without an offset table")

# SOP classes
CT_IMAGE_STORAGE = "1.2.840.10008.5.1.4.1.1.2"
SEGMENTATION_STORAGE = "1.2.840.10008.5.1.4.1.1.66.4"
ENCAPSULATED_PDF_STORAGE = "1.2.840.10008.5.1.4.1.1.104.1"

# pydicom's UID root (so deterministic UIDs match across implementations)
PYDICOM_ROOT_UID = "1.2.826.0.1.3680043.8.498."

# keyword -> (group, element, VR). The subset BOA touches plus what the
# SEG, PDF and RTSTRUCT writers need.
DICT: dict[str, tuple[int, int, str]] = {
    "FileMetaInformationGroupLength": (0x0002, 0x0000, "UL"),
    "FileMetaInformationVersion": (0x0002, 0x0001, "OB"),
    "MediaStorageSOPClassUID": (0x0002, 0x0002, "UI"),
    "MediaStorageSOPInstanceUID": (0x0002, 0x0003, "UI"),
    "TransferSyntaxUID": (0x0002, 0x0010, "UI"),
    "ImplementationClassUID": (0x0002, 0x0012, "UI"),
    "ImplementationVersionName": (0x0002, 0x0013, "SH"),
    "SpecificCharacterSet": (0x0008, 0x0005, "CS"),
    "ImageType": (0x0008, 0x0008, "CS"),
    "InstanceCreationDate": (0x0008, 0x0012, "DA"),
    "InstanceCreationTime": (0x0008, 0x0013, "TM"),
    "SOPClassUID": (0x0008, 0x0016, "UI"),
    "SOPInstanceUID": (0x0008, 0x0018, "UI"),
    "StudyDate": (0x0008, 0x0020, "DA"),
    "SeriesDate": (0x0008, 0x0021, "DA"),
    "AcquisitionDate": (0x0008, 0x0022, "DA"),
    "ContentDate": (0x0008, 0x0023, "DA"),
    "StudyTime": (0x0008, 0x0030, "TM"),
    "SeriesTime": (0x0008, 0x0031, "TM"),
    "ContentTime": (0x0008, 0x0033, "TM"),
    "AccessionNumber": (0x0008, 0x0050, "SH"),
    "Modality": (0x0008, 0x0060, "CS"),
    "Manufacturer": (0x0008, 0x0070, "LO"),
    "ReferringPhysicianName": (0x0008, 0x0090, "PN"),
    "SeriesDescription": (0x0008, 0x103E, "LO"),
    "ManufacturerModelName": (0x0008, 0x1090, "LO"),
    "ReferencedSOPClassUID": (0x0008, 0x1150, "UI"),
    "ReferencedSOPInstanceUID": (0x0008, 0x1155, "UI"),
    "ReferencedSeriesSequence": (0x0008, 0x1115, "SQ"),
    "ReferencedInstanceSequence": (0x0008, 0x114A, "SQ"),
    "PatientName": (0x0010, 0x0010, "PN"),
    "PatientID": (0x0010, 0x0020, "LO"),
    "PatientBirthDate": (0x0010, 0x0030, "DA"),
    "PatientSex": (0x0010, 0x0040, "CS"),
    "KVP": (0x0018, 0x0060, "DS"),
    "SliceThickness": (0x0018, 0x0050, "DS"),
    "SpacingBetweenSlices": (0x0018, 0x0088, "DS"),
    "ExposureTime": (0x0018, 0x1150, "IS"),
    "XRayTubeCurrent": (0x0018, 0x1151, "IS"),
    "Exposure": (0x0018, 0x1152, "IS"),
    "ConvolutionKernel": (0x0018, 0x1210, "SH"),
    "SpiralPitchFactor": (0x0018, 0x9311, "FD"),
    "CTDIvol": (0x0018, 0x9345, "FD"),
    "StudyInstanceUID": (0x0020, 0x000D, "UI"),
    "SeriesInstanceUID": (0x0020, 0x000E, "UI"),
    "StudyID": (0x0020, 0x0010, "SH"),
    "SeriesNumber": (0x0020, 0x0011, "IS"),
    "AcquisitionNumber": (0x0020, 0x0012, "IS"),
    "InstanceNumber": (0x0020, 0x0013, "IS"),
    "ImagePositionPatient": (0x0020, 0x0032, "DS"),
    "ImageOrientationPatient": (0x0020, 0x0037, "DS"),
    "FrameOfReferenceUID": (0x0020, 0x0052, "UI"),
    "PositionReferenceIndicator": (0x0020, 0x1040, "LO"),
    "DimensionOrganizationSequence": (0x0020, 0x9221, "SQ"),
    "DimensionIndexSequence": (0x0020, 0x9222, "SQ"),
    "DimensionOrganizationUID": (0x0020, 0x9164, "UI"),
    "DimensionIndexPointer": (0x0020, 0x9165, "AT"),
    "FunctionalGroupPointer": (0x0020, 0x9167, "AT"),
    "SamplesPerPixel": (0x0028, 0x0002, "US"),
    "PhotometricInterpretation": (0x0028, 0x0004, "CS"),
    "NumberOfFrames": (0x0028, 0x0008, "IS"),
    "Rows": (0x0028, 0x0010, "US"),
    "Columns": (0x0028, 0x0011, "US"),
    "PixelSpacing": (0x0028, 0x0030, "DS"),
    "BitsAllocated": (0x0028, 0x0100, "US"),
    "BitsStored": (0x0028, 0x0101, "US"),
    "HighBit": (0x0028, 0x0102, "US"),
    "PixelRepresentation": (0x0028, 0x0103, "US"),
    "RescaleIntercept": (0x0028, 0x1052, "DS"),
    "RescaleSlope": (0x0028, 0x1053, "DS"),
    "LossyImageCompression": (0x0028, 0x2110, "CS"),
    "LossyImageCompressionMethod": (0x0028, 0x2114, "CS"),
    "SegmentSequence": (0x0062, 0x0002, "SQ"),
    "SegmentedPropertyCategoryCodeSequence": (0x0062, 0x0003, "SQ"),
    "SegmentLabel": (0x0062, 0x0005, "LO"),
    "SegmentAlgorithmType": (0x0062, 0x0008, "CS"),
    "SegmentAlgorithmName": (0x0062, 0x0009, "LO"),
    "SegmentedPropertyTypeCodeSequence": (0x0062, 0x000F, "SQ"),
    "SegmentNumber": (0x0062, 0x0004, "US"),
    "SegmentDescription": (0x0062, 0x0006, "LO"),
    "RecommendedDisplayCIELabValue": (0x0062, 0x000D, "US"),
    "SegmentationType": (0x0062, 0x0001, "CS"),
    "CodeValue": (0x0008, 0x0100, "SH"),
    "CodingSchemeDesignator": (0x0008, 0x0102, "SH"),
    "CodeMeaning": (0x0008, 0x0104, "LO"),
    "ContentLabel": (0x0070, 0x0080, "CS"),
    "ContentDescription": (0x0070, 0x0081, "LO"),
    "ContentCreatorName": (0x0070, 0x0084, "PN"),
    "BodyPartExamined": (0x0018, 0x0015, "CS"),
    "InstanceCreatorUID": (0x0008, 0x0014, "UI"),
    "LossyImageCompressionRatio": (0x0028, 0x2112, "DS"),
    "SharedFunctionalGroupsSequence": (0x5200, 0x9229, "SQ"),
    "PerFrameFunctionalGroupsSequence": (0x5200, 0x9230, "SQ"),
    "PlanePositionSequence": (0x0020, 0x9113, "SQ"),
    "PlaneOrientationSequence": (0x0020, 0x9116, "SQ"),
    "PixelMeasuresSequence": (0x0028, 0x9110, "SQ"),
    "FrameContentSequence": (0x0020, 0x9111, "SQ"),
    "DimensionIndexValues": (0x0020, 0x9157, "UL"),
    "SegmentIdentificationSequence": (0x0062, 0x000A, "SQ"),
    "ReferencedSegmentNumber": (0x0062, 0x000B, "US"),
    "DerivationImageSequence": (0x0008, 0x9124, "SQ"),
    "SourceImageSequence": (0x0008, 0x2112, "SQ"),
    "PurposeOfReferenceCodeSequence": (0x0040, 0xA170, "SQ"),
    "DerivationCodeSequence": (0x0008, 0x9215, "SQ"),
    "DocumentTitle": (0x0042, 0x0010, "ST"),
    "MIMETypeOfEncapsulatedDocument": (0x0042, 0x0012, "LO"),
    "EncapsulatedDocument": (0x0042, 0x0011, "OB"),
    "BurnedInAnnotation": (0x0028, 0x0301, "CS"),
    "ConceptNameCodeSequence": (0x0040, 0xA043, "SQ"),
    "VerificationFlag": (0x0040, 0xA493, "CS"),
    "PixelData": (0x7FE0, 0x0010, "OW"),
    "ScanLength": (0x0018, 0x1302, "IS"),
    "PatientOrientation": (0x0020, 0x0020, "CS"),
    "Laterality": (0x0020, 0x0060, "CS"),
    "SoftwareVersions": (0x0018, 0x1020, "LO"),
    "PatientPosition": (0x0018, 0x5100, "CS"),
    "DeviceSerialNumber": (0x0018, 0x1000, "LO"),
    "StationName": (0x0008, 0x1010, "SH"),
    "InstitutionName": (0x0008, 0x0080, "LO"),
    # RT Structure Set (io/rtstruct.py)
    "StructureSetLabel": (0x3006, 0x0002, "SH"),
    "StructureSetDate": (0x3006, 0x0008, "DA"),
    "StructureSetTime": (0x3006, 0x0009, "TM"),
    "StructureSetROISequence": (0x3006, 0x0020, "SQ"),
    "ROIContourSequence": (0x3006, 0x0039, "SQ"),
    "RTROIObservationsSequence": (0x3006, 0x0080, "SQ"),
    "ROINumber": (0x3006, 0x0022, "IS"),
    "ROIName": (0x3006, 0x0026, "LO"),
    "ROIGenerationAlgorithm": (0x3006, 0x0036, "CS"),
    "ReferencedFrameOfReferenceUID": (0x3006, 0x0024, "UI"),
    "ROIDisplayColor": (0x3006, 0x002A, "IS"),
    "ContourSequence": (0x3006, 0x0040, "SQ"),
    "ContourGeometricType": (0x3006, 0x0042, "CS"),
    "NumberOfContourPoints": (0x3006, 0x0046, "IS"),
    "ContourData": (0x3006, 0x0050, "DS"),
    "ContourImageSequence": (0x3006, 0x0016, "SQ"),
    "ReferencedROINumber": (0x3006, 0x0084, "IS"),
    "ObservationNumber": (0x3006, 0x0082, "IS"),
    "RTROIInterpretedType": (0x3006, 0x00A4, "CS"),
    "ROIInterpreter": (0x3006, 0x00A6, "PN"),
    "ReferencedFrameOfReferenceSequence": (0x3006, 0x0010, "SQ"),
}
TAG_TO_KEYWORD = {(g, e): kw for kw, (g, e, _vr) in DICT.items()}
TAG_TO_VR = {(g, e): vr for kw, (g, e, vr) in DICT.items()}

_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIM = (0xFFFE, 0xE00D)
_SEQ_DELIM = (0xFFFE, 0xE0DD)

# VRs with 4-byte length (explicit VR)
_LONG_VRS = {"OB", "OW", "OF", "OD", "OL", "SQ", "UC", "UR", "UT", "UN"}
_STR_VRS = {"AE", "AS", "CS", "DA", "DS", "DT", "IS", "LO", "LT", "PN", "SH",
            "ST", "TM", "UC", "UI", "UR", "UT"}
_MULTI_NUMERIC = {"DS", "IS"}


class Dataset:
    """Tag-ordered DICOM dataset with keyword attribute access."""

    def __init__(self) -> None:
        object.__setattr__(self, "_elements", {})  # (g,e) -> (vr, value)
        object.__setattr__(self, "file_meta", None)

    # -- dict-ish interface ------------------------------------------------
    def __contains__(self, keyword: str) -> bool:
        return keyword in DICT and DICT[keyword][:2] in self._elements

    def get(self, keyword: "str | tuple[int, int]",
            default: Any = None) -> Any:
        if isinstance(keyword, tuple):  # (group, element) tag access
            el = self._elements.get(keyword)
            return el[1] if el is not None else default
        if keyword in DICT and DICT[keyword][:2] in self._elements:
            return self._elements[DICT[keyword][:2]][1]
        return default

    def __getattr__(self, keyword: str) -> Any:
        if keyword in DICT:
            tag = DICT[keyword][:2]
            if tag in self._elements:
                return self._elements[tag][1]
            raise AttributeError(f"Dataset has no element {keyword}")
        raise AttributeError(keyword)

    def __setattr__(self, keyword: str, value: Any) -> None:
        if keyword in ("file_meta",):
            object.__setattr__(self, keyword, value)
            return
        if keyword in DICT:
            g, e, vr = DICT[keyword]
            self._elements[(g, e)] = (vr, value)
        else:
            object.__setattr__(self, keyword, value)

    def set_raw(self, tag: tuple[int, int], vr: str, value: Any) -> None:
        self._elements[tag] = (vr, value)

    def items(self) -> Iterator[tuple[tuple[int, int], tuple[str, Any]]]:
        return iter(sorted(self._elements.items()))

    def keys(self):
        return self._elements.keys()

    def __repr__(self) -> str:
        parts = []
        for (g, e), (vr, v) in sorted(self._elements.items()):
            kw = TAG_TO_KEYWORD.get((g, e), f"({g:04x},{e:04x})")
            sv = f"<{len(v)} items>" if vr == "SQ" else repr(v)
            parts.append(f"{kw} {vr}: {sv}")
        return "Dataset(\n  " + "\n  ".join(parts) + "\n)"


def generate_uid(entropy_srcs: list[str] | None = None,
                 prefix: str = PYDICOM_ROOT_UID) -> str:
    """pydicom-compatible UID generation: deterministic SHA-512 digits from
    entropy sources, or random (`compute/io.py:92-119` deterministic UIDs)."""
    max_uid_len = 64
    if entropy_srcs is None:
        return prefix + str(secrets.randbits(
            (max_uid_len - len(prefix)) * 3))[: max_uid_len - len(prefix)]
    hash_val = hashlib.sha512("".join(entropy_srcs).encode("utf-8"))
    avail_digits = max_uid_len - len(prefix)
    int_val = int(hash_val.hexdigest(), 16)
    return prefix + str(int_val)[:avail_digits]


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


def _parse_value(vr: str, raw: bytes) -> Any:
    if vr in _STR_VRS:
        s = raw.decode("latin-1", errors="replace")
        s = s.rstrip("\x00 ")
        if vr in _MULTI_NUMERIC:
            parts = [p.strip() for p in s.split("\\") if p.strip()]
            vals: list[float | int] = []
            for p in parts:
                vals.append(int(p) if vr == "IS" else float(p))
            if not vals:
                return None
            return vals[0] if len(vals) == 1 else vals
        if "\\" in s:
            return [p.strip() for p in s.split("\\")]
        return s.strip()
    if vr == "US":
        n = len(raw) // 2
        vals = list(struct.unpack(f"<{n}H", raw[: n * 2]))
        return vals[0] if n == 1 else vals
    if vr == "SS":
        n = len(raw) // 2
        vals = list(struct.unpack(f"<{n}h", raw[: n * 2]))
        return vals[0] if n == 1 else vals
    if vr == "UL":
        n = len(raw) // 4
        vals = list(struct.unpack(f"<{n}I", raw[: n * 4]))
        return vals[0] if n == 1 else vals
    if vr == "SL":
        n = len(raw) // 4
        vals = list(struct.unpack(f"<{n}i", raw[: n * 4]))
        return vals[0] if n == 1 else vals
    if vr == "FL":
        n = len(raw) // 4
        vals = list(struct.unpack(f"<{n}f", raw[: n * 4]))
        return vals[0] if n == 1 else vals
    if vr == "FD":
        n = len(raw) // 8
        vals = list(struct.unpack(f"<{n}d", raw[: n * 8]))
        return vals[0] if n == 1 else vals
    if vr == "AT":
        return struct.unpack("<HH", raw[:4])
    return raw  # OB/OW/UN: bytes


class _Reader:
    def __init__(self, buf: bytes, explicit: bool):
        self.buf = buf
        self.pos = 0
        self.explicit = explicit

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def _u16(self) -> int:
        v = struct.unpack_from("<H", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def _u32(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def read_element(self) -> tuple[tuple[int, int], str, Any]:
        g = self._u16()
        e = self._u16()
        tag = (g, e)
        if tag in (_ITEM, _ITEM_DELIM, _SEQ_DELIM):
            length = self._u32()
            return tag, "NONE", length
        if self.explicit:
            vr = self.buf[self.pos:self.pos + 2].decode("ascii", "replace")
            self.pos += 2
            if vr in _LONG_VRS:
                self.pos += 2  # reserved
                length = self._u32()
            else:
                length = self._u16()
        else:
            vr = TAG_TO_VR.get(tag, "UN")
            length = self._u32()

        if tag == (0x7FE0, 0x0010) and length == 0xFFFFFFFF:
            return tag, vr if vr in ("OB", "OW") else "OB", \
                self._read_fragments()
        if vr == "SQ" or (vr == "UN" and length == 0xFFFFFFFF):
            if vr == "UN" and self.explicit:
                # PS3.5 6.2.2: undefined-length UN contents are IMPLICIT
                # VR LE even inside an explicit-VR file (typical for
                # private sequences surviving implicit->explicit
                # transcoding) — parsing them as explicit desyncs
                prev, self.explicit = self.explicit, False
                try:
                    items = self._read_sequence(length)
                finally:
                    self.explicit = prev
            else:
                items = self._read_sequence(length)
            return tag, "SQ", items
        if length == 0xFFFFFFFF:
            raise ValueError(
                f"Undefined-length element {tag} with VR {vr} is not "
                f"supported by this codec")
        raw = self.buf[self.pos:self.pos + length]
        self.pos += length
        if vr == "UN" and tag in TAG_TO_VR:
            vr = TAG_TO_VR[tag]
        return tag, vr, _parse_value(vr, raw)

    def _read_fragments(self) -> EncapsulatedFrames:
        """Encapsulated pixel-data items up to the sequence delimiter."""
        fragments: list[bytes] = []
        while not self.eof():
            g = self._u16()
            e = self._u16()
            ilen = self._u32()
            if (g, e) == _SEQ_DELIM:
                break
            if (g, e) != _ITEM:
                raise ValueError(
                    f"expected pixel-data item, got ({g:04x},{e:04x})")
            fragments.append(bytes(self.buf[self.pos:self.pos + ilen]))
            self.pos += ilen
        return EncapsulatedFrames(fragments)

    def _read_sequence(self, length: int) -> list[Dataset]:
        items: list[Dataset] = []
        end = None if length == 0xFFFFFFFF else self.pos + length
        while not self.eof():
            if end is not None and self.pos >= end:
                break
            g = self._u16()
            e = self._u16()
            ilen = self._u32()
            if (g, e) == _SEQ_DELIM:
                break
            if (g, e) != _ITEM:
                raise ValueError(f"Expected item tag in sequence, got "
                                 f"({g:04x},{e:04x})")
            item_ds = Dataset()
            if ilen == 0xFFFFFFFF:
                while True:
                    tag, vr, val = self.read_element()
                    if tag == _ITEM_DELIM:
                        break
                    item_ds.set_raw(tag, vr, val)
            else:
                item_end = self.pos + ilen
                while self.pos < item_end:
                    tag, vr, val = self.read_element()
                    item_ds.set_raw(tag, vr, val)
            items.append(item_ds)
        return items


def dcmread(path: str | Path | bytes, stop_before_pixels: bool = False) -> Dataset:
    data = path if isinstance(path, bytes) else Path(path).read_bytes()
    if len(data) < 132 or data[128:132] != b"DICM":
        # raw dataset without preamble: try implicit VR LE
        r = _Reader(data, explicit=False)
        ds = Dataset()
        while not r.eof():
            tag, vr, val = r.read_element()
            if stop_before_pixels and tag == (0x7FE0, 0x0010):
                break
            ds.set_raw(tag, vr, val)
        return ds

    # file meta: always explicit VR LE
    r = _Reader(data, explicit=True)
    r.pos = 132
    meta = Dataset()
    # read group-length first
    tag, vr, val = r.read_element()
    meta.set_raw(tag, vr, val)
    meta_end = r.pos + (val if isinstance(val, int) else 0)
    while r.pos < meta_end:
        tag, vr, val = r.read_element()
        meta.set_raw(tag, vr, val)

    ts = meta.get("TransferSyntaxUID", EXPLICIT_VR_LE)
    if ts not in UNCOMPRESSED and ts not in SUPPORTED_COMPRESSED:
        raise ValueError(
            f"Unsupported transfer syntax {ts}: supported are uncompressed "
            f"little endian, JPEG Baseline/Extended ({JPEG_BASELINE}/"
            f"{JPEG_EXTENDED}), JPEG Lossless ({JPEG_LOSSLESS_SV1}/"
            f"{JPEG_LOSSLESS_P14}), JPEG-LS ({JPEG_LS_LOSSLESS}/"
            f"{JPEG_LS_NEAR_LOSSLESS}), JPEG 2000 ({JPEG_2000_LOSSLESS}/"
            f"{JPEG_2000}) and RLE ({RLE_LOSSLESS}); transcode "
            f"others with dcmdjpeg/gdcmconv first")
    body = _Reader(data, explicit=(ts != IMPLICIT_VR_LE))
    body.pos = r.pos
    ds = Dataset()
    ds.file_meta = meta
    while not body.eof():
        tag, vr, val = body.read_element()
        if stop_before_pixels and tag == (0x7FE0, 0x0010):
            break
        ds.set_raw(tag, vr, val)
    return ds


def pixel_array(ds: Dataset) -> np.ndarray:
    """Decode PixelData to (rows, cols) or (frames, rows, cols).

    Handles uncompressed LE and the encapsulated syntaxes with in-repo
    codecs (JPEG Lossless SV1/P14, JPEG-LS, RLE) — the formats GDCM
    decodes for the reference (`compute/io.py:326-383`).
    """
    raw = ds.get("PixelData")
    if raw is None:
        raise ValueError("Dataset has no PixelData")
    bits = int(ds.get("BitsAllocated", 16))
    signed = int(ds.get("PixelRepresentation", 0)) == 1
    rows, cols = int(ds.get("Rows")), int(ds.get("Columns"))
    nframes = int(ds.get("NumberOfFrames", 1) or 1)
    if isinstance(raw, EncapsulatedFrames):
        ts = (ds.file_meta or Dataset()).get("TransferSyntaxUID", "")
        return _decode_encapsulated(raw, ts, rows, cols, nframes, bits,
                                    signed)
    if bits == 16:
        dt = np.int16 if signed else np.uint16
    elif bits == 8:
        dt = np.int8 if signed else np.uint8
    elif bits == 1:
        total = rows * cols * nframes
        arr = np.unpackbits(np.frombuffer(raw, np.uint8),
                            bitorder="little")[:total]
        return arr.reshape(nframes, rows, cols) if nframes > 1 else \
            arr.reshape(rows, cols)
    else:
        raise ValueError(f"BitsAllocated {bits} not supported")
    arr = np.frombuffer(raw, dt, count=rows * cols * nframes)
    return arr.reshape(nframes, rows, cols) if nframes > 1 else \
        arr.reshape(rows, cols)


def _decode_encapsulated(enc: EncapsulatedFrames, ts: str, rows: int,
                         cols: int, nframes: int, bits: int,
                         signed: bool) -> np.ndarray:
    from boa_tpu_torch.io import dicom_codecs

    frames = enc.frames(nframes)
    decoded = []
    for frame in frames:
        if ts == RLE_LOSSLESS:
            arr = dicom_codecs.decode_rle(frame, rows, cols,
                                          max(bits // 8, 1))
        elif ts in (JPEG_LOSSLESS_SV1, JPEG_LOSSLESS_P14):
            arr = dicom_codecs.decode_jpeg_lossless(frame)
            if arr.shape != (rows, cols):
                raise ValueError(f"frame decoded to {arr.shape}, "
                                 f"expected {(rows, cols)}")
        elif ts in (JPEG_BASELINE, JPEG_EXTENDED):
            arr = dicom_codecs.decode_jpeg_dct(frame)
            if arr.shape[:2] != (rows, cols):
                raise ValueError(f"frame decoded to {arr.shape}, "
                                 f"expected {(rows, cols)}")
        elif ts in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR_LOSSLESS):
            arr = dicom_codecs.decode_jpeg_ls(frame)
            if arr.shape != (rows, cols):
                raise ValueError(f"frame decoded to {arr.shape}, "
                                 f"expected {(rows, cols)}")
        elif ts in (JPEG_2000_LOSSLESS, JPEG_2000):
            arr = dicom_codecs.decode_jpeg2000(frame)
            if arr.shape != (rows, cols):
                raise ValueError(f"frame decoded to {arr.shape}, "
                                 f"expected {(rows, cols)}")
        else:
            raise ValueError(f"no codec for transfer syntax {ts}")
        if bits <= 8:
            arr = arr.astype(np.int8 if signed else np.uint8)
        elif signed:
            arr = arr.astype(np.uint16).view(np.int16)
        else:
            arr = arr.astype(np.uint16)
        decoded.append(arr)
    out = np.stack(decoded) if nframes > 1 else decoded[0]
    return out


def encapsulate(frames: list[bytes]) -> EncapsulatedFrames:
    """Wrap encoded frame blobs as encapsulated PixelData (with BOT)."""
    offsets = []
    pos = 0
    padded = []
    for fr in frames:
        if len(fr) % 2:
            fr = fr + b"\x00"
        offsets.append(pos)
        pos += 8 + len(fr)
        padded.append(fr)
    bot = np.asarray(offsets, "<u4").tobytes() if len(frames) > 1 else b""
    return EncapsulatedFrames([bot, *padded])


# ---------------------------------------------------------------------------
# writing (explicit VR little endian)
# ---------------------------------------------------------------------------


def _encode_value(vr: str, value: Any) -> bytes:
    if value is None:
        return b""
    if vr in _STR_VRS:
        if isinstance(value, (list, tuple)):
            s = "\\".join(_stringify(vr, v) for v in value)
        else:
            s = _stringify(vr, value)
        raw = s.encode("latin-1")
        if len(raw) % 2:
            raw += b"\x00" if vr == "UI" else b" "
        return raw
    if vr in ("US", "SS", "UL", "SL", "FL", "FD"):
        fmt = {"US": "H", "SS": "h", "UL": "I", "SL": "i",
               "FL": "f", "FD": "d"}[vr]
        vals = value if isinstance(value, (list, tuple)) else [value]
        return struct.pack(f"<{len(vals)}{fmt}", *[
            (float(v) if vr in ("FL", "FD") else int(v)) for v in vals])
    if vr == "AT":
        g, e = value
        return struct.pack("<HH", g, e)
    if isinstance(value, np.ndarray):
        value = value.tobytes()
    if isinstance(value, (bytes, bytearray)):
        raw = bytes(value)
        return raw + (b"\x00" if len(raw) % 2 else b"")
    raise TypeError(f"cannot encode VR {vr} value {type(value)}")


def _stringify(vr: str, v: Any) -> str:
    if vr == "DS" and isinstance(v, float):
        s = f"{v:.10g}"
        return s if len(s) <= 16 else f"{v:.8g}"
    if vr == "IS":
        return str(int(v))
    return str(v)


def _write_element(out: bytearray, tag: tuple[int, int], vr: str,
                   value: Any) -> None:
    g, e = tag
    if isinstance(value, EncapsulatedFrames):
        out += struct.pack("<HH", g, e) + b"OB\x00\x00"
        out += struct.pack("<I", 0xFFFFFFFF)
        for frag in value.fragments:
            out += struct.pack("<HHI", *_ITEM, len(frag)) + frag
        out += struct.pack("<HHI", *_SEQ_DELIM, 0)
        return
    if vr == "SQ":
        body = bytearray()
        for item in value:
            item_body = bytearray()
            for t, (ivr, ival) in item.items():
                _write_element(item_body, t, ivr, ival)
            body += struct.pack("<HHI", *_ITEM, len(item_body))
            body += item_body
        out += struct.pack("<HH", g, e) + b"SQ\x00\x00"
        out += struct.pack("<I", len(body))
        out += body
        return
    raw = _encode_value(vr, value)
    out += struct.pack("<HH", g, e)
    if vr in _LONG_VRS:
        out += vr.encode("ascii") + b"\x00\x00" + struct.pack("<I", len(raw))
    else:
        out += vr.encode("ascii") + struct.pack("<H", len(raw))
    out += raw


IMPLEMENTATION_CLASS_UID = PYDICOM_ROOT_UID + "1.84"


def dcmwrite(path: str | Path, ds: Dataset) -> None:
    """Write as Part-10 file, explicit VR little endian."""
    Path(path).write_bytes(dataset_bytes(ds))


def dataset_bytes(ds: Dataset) -> bytes:
    """Part-10 byte serialization (files and DICOMweb STOW uploads)."""
    sop_class = ds.get("SOPClassUID", SEGMENTATION_STORAGE)
    sop_uid = ds.get("SOPInstanceUID") or generate_uid()
    meta = ds.file_meta or Dataset()
    meta.FileMetaInformationVersion = b"\x00\x01"
    meta.MediaStorageSOPClassUID = sop_class
    if not meta.get("MediaStorageSOPInstanceUID"):
        meta.MediaStorageSOPInstanceUID = sop_uid
    if meta.get("TransferSyntaxUID") not in SUPPORTED_COMPRESSED:
        meta.TransferSyntaxUID = EXPLICIT_VR_LE
    meta.ImplementationClassUID = IMPLEMENTATION_CLASS_UID
    meta.ImplementationVersionName = "BOA_TPU"

    meta_body = bytearray()
    for tag, (vr, val) in meta.items():
        if tag == (0x0002, 0x0000):
            continue
        _write_element(meta_body, tag, vr, val)
    out = bytearray(b"\x00" * 128 + b"DICM")
    _write_element(out, (0x0002, 0x0000), "UL", len(meta_body))
    out += meta_body
    for tag, (vr, val) in ds.items():
        _write_element(out, tag, vr, val)
    return bytes(out)


def code_item(value: str, designator: str, meaning: str) -> Dataset:
    item = Dataset()
    item.CodeValue = value
    item.CodingSchemeDesignator = designator
    item.CodeMeaning = meaning
    return item


def rgb_to_cielab_dicom(rgb: tuple[int, int, int]) -> list[int]:
    """sRGB (0-255) -> DICOM PCS CIELab US-encoded triple (dcmqi colors)."""
    def inv_gamma(c: float) -> float:
        c /= 255.0
        return c / 12.92 if c <= 0.04045 else ((c + 0.055) / 1.055) ** 2.4

    r, g, b = (inv_gamma(float(c)) for c in rgb)
    # D65 sRGB -> XYZ
    x = 0.4124564 * r + 0.3575761 * g + 0.1804375 * b
    y = 0.2126729 * r + 0.7151522 * g + 0.0721750 * b
    z = 0.0193339 * r + 0.1191920 * g + 0.9503041 * b
    xn, yn, zn = 0.95047, 1.0, 1.08883

    def f(t: float) -> float:
        return t ** (1 / 3) if t > (6 / 29) ** 3 else \
            t / (3 * (6 / 29) ** 2) + 4 / 29

    fx, fy, fz = f(x / xn), f(y / yn), f(z / zn)
    L = 116 * fy - 16
    a = 500 * (fx - fy)
    bb = 200 * (fy - fz)
    # DICOM encoding: L* 0..100 -> 0..65535; a*,b* -128..127 -> 0..65535
    return [int(round(L / 100 * 65535)),
            int(round((a + 128) / 255 * 65535)),
            int(round((bb + 128) / 255 * 65535))]
