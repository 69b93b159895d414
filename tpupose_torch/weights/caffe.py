"""Native ``.caffemodel`` reader and converter (port of
``tpupose/weights/caffe.py``).

Parses the Caffe ``NetParameter`` protobuf from its wire format (no caffe
or protobuf runtime; only the fields that carry conv weights):

  NetParameter:    layer = 100 (new LayerParameter) / layers = 2 (V1)
  LayerParameter:  name = 1 (string), type = 2, blobs = 7
  V1LayerParameter: name = 4, blobs = 6
  BlobProto:       data = 5 (packed float), shape = 7 (BlobShape),
                   legacy num/channels/height/width = 1/2/3/4
  BlobShape:       dim = 1 (packed int64)

Caffe layer names are the Chainer and model layer names, so conversion is
a repack.  The reference's posenet converter omits ``conv5_5_CPM_L1``;
here the layer is copied when present (``replicate_reference_quirk=True``
skips it as the reference does).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Minimal protobuf wire-format reader
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value).  Length-delimited values are
    memoryviews; varints are ints; fixed32/64 raw ints."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:  # fixed32
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_packed_varints(buf: memoryview) -> List[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _parse_blob(buf: memoryview) -> Optional[np.ndarray]:
    """BlobProto -> ndarray with its declared shape (or legacy NCHW)."""
    data_chunks: List[np.ndarray] = []
    shape: Optional[List[int]] = None
    legacy = {}
    for field, wire, value in _iter_fields(buf):
        if field == 5:  # packed float data
            data_chunks.append(np.frombuffer(value, "<f4"))
        elif field == 8:  # double data
            data_chunks.append(np.frombuffer(value, "<f8").astype(np.float32))
        elif field == 7 and wire == 2:  # BlobShape
            for f2, w2, v2 in _iter_fields(value):
                if f2 == 1:
                    if w2 == 2:
                        shape = _parse_packed_varints(v2)
                    else:
                        shape = (shape or []) + [v2]
        elif field in (1, 2, 3, 4) and wire == 0:  # legacy dims
            legacy[field] = value
    if not data_chunks:
        return None
    data = np.concatenate(data_chunks) if len(data_chunks) > 1 \
        else data_chunks[0]
    if shape:
        return data.reshape(shape)
    if legacy:
        dims = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
        return data.reshape(dims)
    return data


def _parse_layer(buf: memoryview, name_field: int,
                 blobs_field: int) -> Tuple[str, List[np.ndarray]]:
    name = ""
    blobs: List[np.ndarray] = []
    for field, wire, value in _iter_fields(buf):
        if field == name_field and wire == 2:
            name = bytes(value).decode("utf-8", "replace")
        elif field == blobs_field and wire == 2:
            blob = _parse_blob(value)
            if blob is not None:
                blobs.append(blob)
    return name, blobs


def load_caffemodel(path: str) -> Dict[str, List[np.ndarray]]:
    """Parse a ``.caffemodel`` into {layer_name: [W, b, ...]} arrays."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    layers: Dict[str, List[np.ndarray]] = {}
    for field, wire, value in _iter_fields(buf):
        if field == 100 and wire == 2:      # new-format LayerParameter
            name, blobs = _parse_layer(value, name_field=1, blobs_field=7)
        elif field == 2 and wire == 2:      # V1LayerParameter
            name, blobs = _parse_layer(value, name_field=4, blobs_field=6)
        else:
            continue
        if name and blobs:
            layers[name] = blobs
    return layers


# ---------------------------------------------------------------------------
# Conversion to the framework's npz / param-tree formats
# ---------------------------------------------------------------------------

# Conv layers per arch, in network order: the reference converter's lists
# plus its omitted conv5_5_CPM_L1.
POSENET_LAYERS = (
    ["conv1_1", "conv1_2", "conv2_1", "conv2_2",
     "conv3_1", "conv3_2", "conv3_3", "conv3_4",
     "conv4_1", "conv4_2", "conv4_3_CPM", "conv4_4_CPM"]
    + [f"conv5_{i}_CPM_L{b}" for b in (1, 2) for i in (1, 2, 3, 4, 5)]
    + [f"Mconv{i}_stage{s}_L{b}"
       for s in range(2, 7) for b in (1, 2) for i in range(1, 8)]
)
_FACE_HAND_STEM = (
    ["conv1_1", "conv1_2", "conv2_1", "conv2_2",
     "conv3_1", "conv3_2", "conv3_3", "conv3_4",
     "conv4_1", "conv4_2", "conv4_3", "conv4_4",
     "conv5_1", "conv5_2", "conv5_3_CPM"]
    + ["conv6_1_CPM", "conv6_2_CPM"]
    + [f"Mconv{i}_stage{s}" for s in range(2, 7) for i in range(1, 8)]
)
FACENET_LAYERS = list(_FACE_HAND_STEM)
HANDNET_LAYERS = list(_FACE_HAND_STEM)
ARCH_LAYERS = {
    "posenet": POSENET_LAYERS,
    "facenet": FACENET_LAYERS,
    "handnet": HANDNET_LAYERS,
}

# Layers the reference converter skips.
REFERENCE_QUIRK_SKIP = {"posenet": {"conv5_5_CPM_L1"}}


def caffemodel_to_flat(path: str, arch: str,
                       replicate_reference_quirk: bool = False,
                       verbose: bool = True) -> Dict[str, np.ndarray]:
    """caffemodel -> flat {"<layer>/W": OIHW, "<layer>/b": bias} dict
    (the Chainer-npz layout of ``save_chainer_npz``)."""
    caffe_layers = load_caffemodel(path)
    skip = (REFERENCE_QUIRK_SKIP.get(arch, set())
            if replicate_reference_quirk else set())
    flat: Dict[str, np.ndarray] = {}
    for name in ARCH_LAYERS[arch]:
        if name in skip:
            if verbose:
                print(f"Skipping layer {name} (reference quirk)")
            continue
        if name not in caffe_layers:
            if verbose:
                print(f"Failed to copy layer {name}! (not in caffemodel)")
            continue
        blobs = caffe_layers[name]
        w = np.asarray(blobs[0], np.float32)
        if w.ndim != 4:
            w = w.reshape(w.shape[-4:]) if w.size else w
        flat[f"{name}/W"] = w
        if len(blobs) > 1:
            flat[f"{name}/b"] = np.asarray(blobs[1], np.float32).reshape(-1)
        if verbose:
            print(f"Succeed to copy layer {name}")
    return flat


def convert_caffemodel(caffe_path: str, npz_path: str, arch: str,
                       replicate_reference_quirk: bool = False) -> None:
    """CLI core: caffemodel -> Chainer-compatible npz
    (parity with ``convert_model.py``'s output format)."""
    flat = caffemodel_to_flat(
        caffe_path, arch,
        replicate_reference_quirk=replicate_reference_quirk)
    np.savez(npz_path, **flat)
    print(f"Saved {len(flat)} arrays into '{npz_path}'.")


VGG_LAYERS = ("conv1_1", "conv1_2", "conv2_1", "conv2_2",
              "conv3_1", "conv3_2", "conv3_3", "conv3_4",
              "conv4_1", "conv4_2")


def init_stem_from_caffe_vgg(model, caffe_path: str,
                             verbose: bool = True) -> None:
    """Warm-start the VGG-19 stem conv1_1..conv4_2 of a ``CocoPoseNet`` in
    place from a Caffe VGG release (the reference's ``copy_vgg_params``)."""
    import torch

    caffe_layers = load_caffemodel(caffe_path)
    for name in VGG_LAYERS:
        if name not in caffe_layers:
            if verbose:
                print(f"VGG layer {name} missing in caffemodel")
            continue
        w, b = caffe_layers[name][0], caffe_layers[name][1]
        conv = getattr(model.stem, name).conv
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(
                np.array(w, np.float32).reshape(conv.weight.shape)))
            conv.bias.copy_(torch.from_numpy(
                np.array(b, np.float32).reshape(-1)))
        if verbose:
            print(f"Copied VGG layer {name}")
