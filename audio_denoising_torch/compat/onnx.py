"""A self-contained ONNX reader and executor (JAX counterpart
compat/onnx.py): no ``onnx`` or ``onnxruntime`` package.

- ``parse_onnx``: a minimal protobuf wire-format decoder for the
  ModelProto subset that the reference's MOMO2 cell exports
  (``momo2_01.onnx``, ``momo2_02.onnx``, ``my_model.onnx``) and both
  packages' exporters (``compat/onnx_export.py``) write: the graph, its
  nodes, attributes, initializers and value infos. Pure numpy, a copy of
  the JAX package's decoder.
- ``run_graph``: an eager executor of that op set on torch tensors on an
  explicit device: Conv and ConvTranspose through ``ops/convs.py`` in full
  fp32 (``pipeline.fp32_convs``), GRU through ``models/gru.gru_layer``,
  Batch and Instance normalization, PRelu, the activations and the shape
  ops. Each op follows the expression of the port's own model for it, so
  a graph exported from a port model runs bit for bit as that model.
- ``momo_config_from_onnx`` and ``onnx_params``: a MOMO cell graph as a
  ModelConfig, its bin count and a torch state dict the port's MOMO
  models load (``hub.load_pretrained("x.onnx")``).
"""

import struct
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple, \
    Union

import numpy as np
import torch

# ----------------------------------------------------------------------------
# protobuf wire decoding
# ----------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
           7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


class Tensor(NamedTuple):
    name: str
    array: np.ndarray


def _parse_tensor(buf: bytes) -> Tensor:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif field == 2:
            dtype = val
        elif field == 4:   # float_data
            if wire == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 7:   # int64_data (sign-extend: negatives are 10-byte
            # varints encoding v + 2^64)
            if wire == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            else:
                ints.append(val - (1 << 64) if val >= (1 << 63) else val)
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif ints:
        arr = np.asarray(ints, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    return Tensor(name, arr.reshape(dims) if dims else arr.reshape(()))


class Attribute(NamedTuple):
    name: str
    value: Any


def _parse_attribute(buf: bytes) -> Attribute:
    name = ""
    f = i = s = t = None
    floats: List[float] = []
    ints: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            f = struct.unpack("<f", val)[0]
        elif field == 3:
            i = val - (1 << 64) if val >= (1 << 63) else val
        elif field == 4:
            s = val.decode(errors="replace")
        elif field == 5:
            t = _parse_tensor(val).array
        elif field == 7:
            if wire == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8:
            if wire == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            else:
                ints.append(val - (1 << 64) if val >= (1 << 63) else val)
    for v in (t, s, f, i):
        if v is not None:
            return Attribute(name, v)
    if ints:
        return Attribute(name, ints)
    if floats:
        return Attribute(name, floats)
    return Attribute(name, None)


class Node(NamedTuple):
    op_type: str
    name: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    attrs: Dict[str, Any]


class Graph(NamedTuple):
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[Tuple[str, Optional[Tuple[int, ...]]]]
    outputs: List[str]


def _parse_value_info(buf: bytes) -> Tuple[str, Optional[Tuple[int, ...]]]:
    name = ""
    shape = None
    for field, _w, val in _fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:  # TypeProto
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _fields(v2):
                        if f3 == 2:  # shape
                            dims = []
                            for f4, _w4, v4 in _fields(v3):
                                if f4 == 1:  # dim
                                    dv = 0
                                    for f5, _w5, v5 in _fields(v4):
                                        if f5 == 1:
                                            dv = v5
                                    dims.append(dv)
                            shape = tuple(dims)
    return name, shape


def _parse_node(buf: bytes) -> Node:
    inputs: List[str] = []
    outputs: List[str] = []
    name = op = ""
    attrs: Dict[str, Any] = {}
    for field, _w, val in _fields(buf):
        if field == 1:
            inputs.append(val.decode())
        elif field == 2:
            outputs.append(val.decode())
        elif field == 3:
            name = val.decode()
        elif field == 4:
            op = val.decode()
        elif field == 5:
            a = _parse_attribute(val)
            attrs[a.name] = a.value
    return Node(op, name, tuple(inputs), tuple(outputs), attrs)


def parse_onnx(path: str) -> Graph:
    with open(path, "rb") as f:
        data = f.read()
    graph_buf = None
    for field, _w, val in _fields(data):
        if field == 7:       # ModelProto.graph
            graph_buf = val
    if graph_buf is None:
        raise ValueError(f"{path}: no graph found")
    nodes, inits, inputs, outputs = [], {}, [], []
    for field, _w, val in _fields(graph_buf):
        if field == 1:
            nodes.append(_parse_node(val))
        elif field == 5:
            t = _parse_tensor(val)
            inits[t.name] = t.array
        elif field == 11:
            inputs.append(_parse_value_info(val))
        elif field == 12:
            outputs.append(_parse_value_info(val)[0])
    return Graph(nodes, inits, inputs, outputs)


# --------------------------------------------------------------------------
# executor
# --------------------------------------------------------------------------

_TORCH_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                 6: torch.int32, 7: torch.int64, 9: torch.bool,
                 10: torch.float16, 11: torch.float64}


def _ints(v) -> List[int]:
    """An ONNX list operand (a tensor or an attribute) as Python ints."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          attrs: Mapping[str, Any], transpose: bool) -> torch.Tensor:
    from audio_denoising_torch.ops import convs
    from audio_denoising_torch.pipeline import fp32_convs
    rank = x.dim() - 2
    dil = attrs.get("dilations")
    if dil is not None and any(d != 1 for d in dil):
        raise NotImplementedError(f"ONNX conv dilations {dil}")
    if attrs.get("auto_pad") not in (None, "NOTSET"):
        raise NotImplementedError(f"ONNX conv auto_pad {attrs['auto_pad']!r}")
    if rank not in (1, 2):
        raise NotImplementedError(f"ONNX conv of rank {rank}")
    group = attrs.get("group", 1)
    strides = list(attrs.get("strides", [1] * rank))
    pads = attrs.get("pads") or [0] * (2 * rank)
    if list(pads[:rank]) != list(pads[rank:]):
        raise NotImplementedError(f"asymmetric ONNX conv pads {pads}")
    pads = list(pads[:rank])
    if (transpose or rank == 2) and group != 1:
        raise NotImplementedError("grouped ONNX ConvTranspose or 2-D Conv")
    one = (lambda v: v[0]) if rank == 1 else (lambda v: tuple(v))
    with fp32_convs():
        if transpose:
            out_pad = list(attrs.get("output_padding", [0] * rank))
            fn = convs.conv_transpose1d if rank == 1 else \
                convs.conv_transpose2d
            return fn(x, w, b, stride=one(strides), padding=one(pads),
                      output_padding=one(out_pad))
        if rank == 1:
            return convs.conv1d(x, w, b, stride=strides[0], padding=pads[0],
                                groups=group)
        return convs.conv2d(x, w, b, stride=tuple(strides),
                            padding=tuple(pads))


def _gru(node: Node, ins: List[Optional[torch.Tensor]],
         env: Dict[str, Any]) -> None:
    """ONNX GRU with linear_before_reset=1 (torch's semantics): X (T, B,
    I), W (D, 3H, I), R (D, 3H, H), B (D, 6H) in ONNX's gate order z, r,
    h, reordered back to torch's r, z, n for models/gru.gru_layer, the
    port's own GRU step. Outputs Y (T, D, B, H) and Y_h (D, B, H)."""
    from audio_denoising_torch.models.gru import gru_layer
    a = node.attrs
    if a.get("linear_before_reset", 0) != 1:
        raise NotImplementedError(
            "ONNX GRU with linear_before_reset=0 (torch exports use 1)")
    X, W, R = ins[0].float(), ins[1].float(), ins[2].float()
    H = a["hidden_size"]
    n_dir = W.shape[0]
    Bv = (ins[3].float() if len(ins) > 3 and ins[3] is not None
          else torch.zeros((n_dir, 6 * H), device=X.device))
    direction = a.get("direction", "forward")
    rzn = lambda m: torch.cat([m[H:2 * H], m[:H], m[2 * H:]])
    xbtc = X.transpose(0, 1)                              # (B, T, I)
    ys, hs = [], []
    for d in range(n_dir):
        rev = direction == "reverse" or d == 1
        y, h = gru_layer(xbtc, torch.zeros((X.shape[1], H), device=X.device),
                         rzn(W[d]), rzn(Bv[d][:3 * H]), rzn(R[d]),
                         rzn(Bv[d][3 * H:]), reverse=rev)
        ys.append(y.transpose(0, 1))                      # (T, B, H)
        hs.append(h)
    env[node.outputs[0]] = torch.stack(ys, dim=1)
    if len(node.outputs) > 1 and node.outputs[1]:
        env[node.outputs[1]] = torch.stack(hs)


def _channel(v: torch.Tensor, rank: int) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over (N, C, ...)."""
    return v.reshape((1, -1) + (1,) * (rank - 2))


def run_graph(graph: Graph,
              feeds: Mapping[str, Union[np.ndarray, torch.Tensor]],
              device: Union[str, torch.device] = "cpu"
              ) -> Dict[str, torch.Tensor]:
    """Run ``graph`` eagerly on ``device`` (the JAX package runs it on
    jax.numpy): ``feeds`` by input name, numpy arrays or tensors; returns
    the graph's outputs by name as tensors on ``device``. The device is
    the caller's to name: an executor of a file has no default card."""
    from audio_denoising_torch.models.unet2d import prelu
    device = torch.device(device)
    env: Dict[str, Any] = {k: torch.as_tensor(np.array(v), device=device)
                           for k, v in graph.initializers.items()}
    env.update({k: torch.as_tensor(v, device=device)
                if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.array(v), device=device)
                for k, v in feeds.items()})
    with torch.no_grad():
        for node in graph.nodes:
            ins = [env[i] if i else None for i in node.inputs]
            op, a = node.op_type, node.attrs
            if op in ("Conv", "ConvTranspose"):
                out = _conv(ins[0].float(), ins[1].float(),
                            ins[2].float() if len(ins) > 2 else None, a,
                            transpose=op == "ConvTranspose")
            elif op == "Relu":
                out = torch.relu(ins[0])
            elif op == "PRelu":
                x_, slope = ins[0], ins[1]
                # unidirectional broadcast from the channel axis
                if slope.dim() not in (0, 1) and slope.dim() != x_.dim():
                    slope = _channel(slope, x_.dim())
                out = prelu(x_, slope)
            elif op == "BatchNormalization":
                # inference mode on the stored statistics, as
                # models/trunet.BatchNorm1d computes it
                x_ = ins[0].float()
                scale, bias, mean, var = (_channel(v.float(), x_.dim())
                                          for v in ins[1:5])
                out = ((x_ - mean) * torch.rsqrt(var + a.get("epsilon", 1e-5))
                       * scale + bias)
            elif op == "GRU":
                _gru(node, ins, env)
                continue
            elif op == "InstanceNormalization":
                # models/unet2d.instance_norm_2d's expression, then the
                # affine
                x_ = ins[0].float()
                dims = tuple(range(2, x_.dim()))
                mean = x_.mean(dim=dims, keepdim=True)
                var = ((x_ - mean) ** 2).mean(dim=dims, keepdim=True)
                out = ((x_ - mean) * torch.rsqrt(var + a.get("epsilon", 1e-5))
                       * _channel(ins[1].float(), x_.dim())
                       + _channel(ins[2].float(), x_.dim()))
            elif op == "Sigmoid":
                out = torch.sigmoid(ins[0])
            elif op == "Tanh":
                out = torch.tanh(ins[0])
            elif op == "Add":
                out = ins[0] + ins[1]
            elif op == "Sub":
                out = ins[0] - ins[1]
            elif op == "Mul":
                out = ins[0] * ins[1]
            elif op == "Concat":
                out = torch.cat(list(ins), dim=a.get("axis", 0))
            elif op == "Split":
                axis = a.get("axis", 0)
                if len(ins) > 1 and ins[1] is not None:
                    sizes = _ints(ins[1])
                else:
                    sizes = a.get("split")
                if not sizes:
                    k = len(node.outputs)
                    sizes = [ins[0].shape[axis] // k] * k
                for nm, pt in zip(node.outputs,
                                  torch.split(ins[0], list(sizes), dim=axis)):
                    env[nm] = pt
                continue
            elif op == "Slice":
                data = ins[0]
                starts, ends = _ints(ins[1]), _ints(ins[2])
                axes = (_ints(ins[3]) if len(ins) > 3 and ins[3] is not None
                        else list(range(len(starts))))
                steps = (_ints(ins[4]) if len(ins) > 4 and ins[4] is not None
                         else [1] * len(starts))
                sl = [slice(None)] * data.dim()
                for st, en, ax, sp in zip(starts, ends, axes, steps):
                    if sp < 1:
                        raise NotImplementedError("ONNX Slice with steps < 1")
                    sl[ax] = slice(st, en, sp)
                out = data[tuple(sl)]
            elif op in ("Squeeze", "Unsqueeze"):
                axes = (_ints(ins[1]) if len(ins) > 1 and ins[1] is not None
                        else a.get("axes"))
                out = ins[0]
                if op == "Squeeze":
                    out = (out.squeeze() if not axes else
                           out.squeeze(tuple(int(x) for x in axes)))
                else:
                    for ax in sorted(int(x) for x in axes):
                        out = out.unsqueeze(ax)
            elif op == "Transpose":
                perm = a.get("perm") or list(range(ins[0].dim()))[::-1]
                out = ins[0].permute(*perm)
            elif op == "Gather":
                axis = a.get("axis", 0)
                idx = ins[1].long()
                out = torch.index_select(ins[0], axis, idx.reshape(-1))
                out = out.reshape(ins[0].shape[:axis % ins[0].dim()]
                                  + idx.shape
                                  + ins[0].shape[axis % ins[0].dim() + 1:])
            elif op == "Shape":
                out = torch.tensor(list(ins[0].shape), dtype=torch.int64,
                                   device=device)
            elif op == "Constant":
                out = torch.as_tensor(np.asarray(a.get("value")),
                                      device=device)
            elif op == "Cast":
                out = ins[0].to(_TORCH_DTYPES.get(a.get("to", 1),
                                                  torch.float32))
            elif op == "Identity":
                out = ins[0]
            elif op == "Div":
                x0, x1 = ins[0], ins[1]
                if not (x0.is_floating_point() or x1.is_floating_point()):
                    # ONNX integer Div truncates toward zero
                    out = torch.div(x0, x1, rounding_mode="trunc")
                else:
                    out = x0 / x1
            elif op == "Pow":
                out = torch.pow(ins[0].float(), ins[1].float())
            elif op == "Exp":
                out = torch.exp(ins[0])
            elif op == "Equal":
                out = ins[0] == ins[1]
            elif op == "Where":
                out = torch.where(ins[0].bool(), ins[1], ins[2])
            elif op == "Expand":
                shape = tuple(np.broadcast_shapes(tuple(ins[0].shape),
                                                  tuple(_ints(ins[1]))))
                out = ins[0].expand(shape)
            elif op == "ConstantOfShape":
                value = a.get("value")
                fill = (np.asarray(value).reshape(-1)[0]
                        if value is not None else np.float32(0.0))
                out = torch.full(_ints(ins[0]), fill.item(),
                                 dtype=torch.as_tensor(fill).dtype,
                                 device=device)
            elif op == "Reshape":
                out = ins[0].reshape(_ints(ins[1]))
            else:
                raise NotImplementedError(f"ONNX op {op} ({node.name})")
            env[node.outputs[0]] = out
    return {name: env[name] for name in graph.outputs}


# -----------------------------------------------------------------------------
# MOMO cell graphs as servable models
# -----------------------------------------------------------------------------


def _input_gate_convs(graph: Graph) -> List[Node]:
    return sorted((n for n in graph.nodes if n.op_type == "Conv"
                   and "/input_gate/downs." in n.name), key=lambda n: n.name)


def momo_config_from_onnx(graph: Graph):
    """(ModelConfig, num_bins) of a MOMO cell graph, read from its input
    gate's conv nodes and initializer shapes (their names are the torch
    state-dict keys). A graph with a ``prev`` input is a delta cell
    (MOMO3: the first conv reads x, x - prev and the smearing field);
    without it, MOMO2, as the JAX package reads every graph (the
    reference's exports are MOMO2 cells). Graphs of the other families
    raise NotImplementedError: the GRUUNet cell (its encoder concatenates
    a smearing field at every level), the U-Nets and TRUNet (no input
    gate), which the JAX package misreads as MOMO2 or fails on."""
    from audio_denoising_torch.config import ModelConfig
    downs = _input_gate_convs(graph)
    names = {n.name for n in graph.nodes}
    if not downs or any(nm.startswith("/cell/input_gate/downs.")
                        and nm.endswith("/Concat") for nm in names):
        raise NotImplementedError(
            "not a MOMO cell graph: hub .onnx specs are MOMO2/MOMO3 cell "
            "exports (the reference's momo2_*.onnx, or `convert` of a MOMO "
            "checkpoint); serve other families from their .npz")
    strides, paddings, kernels, hidden = [], [], [], []
    for n in downs:
        strides.append(n.attrs["strides"][0])
        paddings.append(n.attrs["pads"][0])
        kernels.append(n.attrs["kernel_shape"][0])
        hidden.append(graph.initializers[n.inputs[1]].shape[0])
    hidden[-1] //= 3                      # the last level emits 3 gates
    num_bins = next(s[-1] for name, s in graph.inputs
                    if name == "input" and s)
    delta = any(name == "prev" for name, _s in graph.inputs)
    in_ch = graph.initializers[downs[0].inputs[1]].shape[1]
    cfg = ModelConfig(
        arch="MOMO3" if delta else "MOMO2", in_size=1,
        hidden_sizes=tuple(hidden), kernel_sizes=tuple(kernels),
        strides=tuple(strides), paddings=tuple(paddings),
        num_compressed_bins=_down_out(num_bins, kernels, strides, paddings),
        num_gaussians=in_ch - (2 if delta else 1))
    return cfg, num_bins


def _down_out(n, ks, ss, ps):
    for k, s, p in zip(ks, ss, ps):
        n = (n + 2 * p - k) // s + 1
    return n


def onnx_params(graph: Graph) -> Dict[str, torch.Tensor]:
    """The cell's initializers (named by the torch state-dict keys) as a
    float32 state dict for the port's models."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in graph.initializers.items() if k.startswith("cell.")}
