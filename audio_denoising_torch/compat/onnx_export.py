"""Self-contained ONNX export, the write half of ``compat/onnx.py`` (JAX
counterpart compat/onnx_export.py): no ``onnx`` or protobuf package.

``write_onnx`` serializes a ``Graph`` to ModelProto wire bytes, field for
field the structure ``parse_onnx`` decodes (opset 12: Squeeze, Unsqueeze
and Split take their axes and sizes as attributes). ``export_cell`` reads
one of the port's models, its ``nn.Module`` and parameters, and writes:

- a MOMO2/MOMO3 or GRUUNet2/GRUUNet cell step with explicit state IO
  (``input``, ``prev`` for a delta cell, ``h0`` in; ``output``, ``hx``
  out), the momo2_02.onnx layout, with the reference's node names for the
  core convs (``/cell/input_gate/downs.N/conv/Conv``) and the Gaussian
  smearing fields as initializers;
- a stateless U-Net's whole segment forward at a fixed frame count;
- TRUNet's core forward, (1, 4, bins) -> (1, 5, bins): depthwise convs as
  Conv ``group``, BatchNorm in inference mode, the GRUs as ONNX ``GRU``
  with ``linear_before_reset=1`` and ONNX's z, r, h gate order.

The graphs, node for node and initializer for initializer, are the JAX
exporter's: on the same weights the two packages write the same bytes.
Round trip (test-held): write, ``parse_onnx``, ``run_graph`` equals the
model.
"""

import struct
from typing import Any, Dict, List, Sequence

import numpy as np
from torch import nn

from audio_denoising_torch.compat.onnx import Graph, Node

# TensorProto data types (mirrors _DTYPES in onnx.py)
_NP_TO_ONNX = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.int32): 6, np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10, np.dtype(np.float64): 11,
}


# -- protobuf wire encoding ------------------------------------------------

def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64                      # negatives: 10-byte two's complement
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return _key(field, 2) + _varint(len(payload)) + payload


def _vi(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


# -- proto message encoders ------------------------------------------------

def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = _NP_TO_ONNX.get(arr.dtype)
    if dt is None:
        arr = arr.astype(np.float32)
        dt = 1
    out = b"".join(_vi(1, d) for d in arr.shape)
    out += _vi(2, dt)
    out += _ld(8, name.encode())
    out += _ld(9, arr.tobytes())          # raw_data
    return out


def _attribute(name: str, value: Any) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, np.ndarray):
        out += _ld(5, _tensor("", value)) + _vi(20, 4)       # TENSOR
    elif isinstance(value, bool):
        out += _vi(3, int(value)) + _vi(20, 2)               # INT
    elif isinstance(value, int):
        out += _vi(3, value) + _vi(20, 2)                    # INT
    elif isinstance(value, float):
        out += _key(2, 5) + struct.pack("<f", value) + _vi(20, 1)
    elif isinstance(value, str):
        out += _ld(4, value.encode()) + _vi(20, 3)           # STRING
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            out += b"".join(_vi(8, int(v)) for v in value) + _vi(20, 7)
        else:
            out += b"".join(_key(7, 5) + struct.pack("<f", float(v))
                            for v in value) + _vi(20, 6)     # FLOATS
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return out


def _node(n: Node) -> bytes:
    out = b"".join(_ld(1, i.encode()) for i in n.inputs)
    out += b"".join(_ld(2, o.encode()) for o in n.outputs)
    out += _ld(3, n.name.encode())
    out += _ld(4, n.op_type.encode())
    out += b"".join(_ld(5, _attribute(k, v)) for k, v in n.attrs.items())
    return out


def _value_info(name: str, shape: Sequence[int]) -> bytes:
    dims = b"".join(_ld(1, _vi(1, int(d))) for d in shape)
    tensor_type = _vi(1, 1) + _ld(2, dims)      # elem_type=float32, shape
    return _ld(1, name.encode()) + _ld(2, _ld(1, tensor_type))


def write_onnx(graph: Graph, path: str,
               input_shapes: Dict[str, Sequence[int]] = None,
               output_shapes: Dict[str, Sequence[int]] = None,
               opset: int = 12) -> str:
    """Serialize a Graph to an ONNX ModelProto file.

    Default opset is 12: the cell builder encodes Unsqueeze/Squeeze
    ``axes`` and Split ``split`` as node ATTRIBUTES, the pre-opset-13
    form — declaring a later opset would make the artifact spec-invalid
    for conformant runtimes (opset 13 moved those to inputs). Pass the
    source model's opset when re-serializing a parsed graph."""
    input_shapes = input_shapes or {}
    g = b"".join(_ld(1, _node(n)) for n in graph.nodes)
    # the graph name JAX's exporter writes: the two packages' artifacts
    # of one model are byte-identical
    g += _ld(2, b"audio_denoising_tpu")
    g += b"".join(_ld(5, _tensor(nm, arr))
                  for nm, arr in graph.initializers.items())
    for nm, shape in graph.inputs:
        g += _ld(11, _value_info(nm, shape or input_shapes.get(nm, ())))
    for nm in graph.outputs:
        g += _ld(12, _value_info(nm, (output_shapes or {}).get(nm, ())))
    model = _vi(1, 8)                                  # ir_version
    model += _ld(8, _vi(2, opset))                     # opset_import
    model += _ld(7, g)
    with open(path, "wb") as f:
        f.write(model)
    return path


# -- GRUUNet2 cell export --------------------------------------------------

def _params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and persistent buffers by state-dict name,
    as float32 numpy arrays."""
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in model.state_dict().items()}


def _buf(module: nn.Module, name: str) -> np.ndarray:
    return getattr(module, name).detach().cpu().numpy().astype(np.float32)


def export_gruunet_cell(model, path: str) -> str:
    """One GRUUNet2/GRUUNet cell step (models/gruunet.py) as ONNX: the
    reference's momo2 op set and node names, the smearing field of every
    level as an initializer. Inputs ``input`` (1, F), ``h0`` (1, hidden,
    compressed); outputs ``output`` (1, F), ``hx``."""
    params = _params(model)
    cell = model.cell
    c = model.config
    F = model.num_bins
    levels = cell.levels
    hidden = cell.hidden

    nodes: List[Node] = []
    inits: Dict[str, np.ndarray] = {}

    def add(op, name, ins, outs, **attrs):
        nodes.append(Node(op, name, tuple(ins), tuple(outs), attrs))
        return outs[0]

    x2 = add("Unsqueeze", "/cell/Unsqueeze_x", ["input"], ["x_img"],
             axes=[1])

    # encoder: smear concat at EVERY level (gruunet cell, reference
    # gruunet2.py:139-143), then strided Conv1d + Relu
    h = x2
    skip_names = [x2]
    for i in range(levels):
        sm = f"smear_down{i}"
        inits[sm] = _buf(cell, f"smear_down{i}")[None]
        cat = add("Concat", f"/cell/input_gate/downs.{i}/Concat",
                  [h, sm], [f"ig_cat{i}"], axis=1)
        wname = f"cell.input_gate.downs.{i}.conv.weight"
        bname = f"cell.input_gate.downs.{i}.conv.bias"
        inits[wname] = np.asarray(params[wname], np.float32)
        inits[bname] = np.asarray(params[bname], np.float32)
        conv = add("Conv", f"/cell/input_gate/downs.{i}/conv/Conv",
                   [cat, wname, bname], [f"ig_conv{i}"],
                   strides=[int(c.strides[i])],
                   pads=[int(c.paddings[i])] * 2,
                   kernel_shape=[int(c.kernel_sizes[i])])
        h = add("Relu", f"/cell/input_gate/downs.{i}/Relu", [conv],
                [f"ig_act{i}"])
        if i != levels - 1:
            skip_names.append(h)

    inits["smear_hx"] = _buf(cell, "smear_hx")[None]
    hcat = add("Concat", "/cell/reset_gate/Concat", ["h0", "smear_hx"],
               ["rg_in"], axis=1)
    inits["cell.reset_gate.downs.0.conv.weight"] = np.asarray(
        params["cell.reset_gate.downs.0.conv.weight"], np.float32)
    inits["cell.reset_gate.downs.0.conv.bias"] = np.asarray(
        params["cell.reset_gate.downs.0.conv.bias"], np.float32)
    rg = add("Conv", "/cell/reset_gate/downs.0/conv/Conv",
             [hcat, "cell.reset_gate.downs.0.conv.weight",
              "cell.reset_gate.downs.0.conv.bias"], ["rg_conv"],
             strides=[1], pads=[1, 1], kernel_shape=[3])
    rg = add("Relu", "/cell/reset_gate/downs.0/Relu", [rg], ["rg_act"])

    nodes.append(Node("Split", "/cell/Split_i", (f"ig_act{levels - 1}",),
                      ("i_r", "i_i", "i_n"),
                      {"axis": 1, "split": [hidden] * 3}))
    nodes.append(Node("Split", "/cell/Split_h", (rg,),
                      ("h_r", "h_i", "h_n"),
                      {"axis": 1, "split": [hidden] * 3}))
    ig = add("Add", "/cell/Add_i", ["i_i", "h_i"], ["pre_ig"])
    ig = add("Sigmoid", "/cell/Sigmoid", [ig], ["inputgate"])
    rgate = add("Add", "/cell/Add_r", ["i_r", "h_r"], ["pre_rg"])
    rgate = add("Sigmoid", "/cell/Sigmoid_1", [rgate], ["resetgate"])
    rn = add("Mul", "/cell/Mul_rn", [rgate, "h_n"], ["r_hn"])
    ng = add("Add", "/cell/Add_n", ["i_n", rn], ["pre_ng"])
    ng = add("Tanh", "/cell/Tanh", [ng], ["newgate"])
    hdiff = add("Sub", "/cell/Sub_h", ["h0", ng], ["h_minus_n"])
    upd = add("Mul", "/cell/Mul_upd", [ig, hdiff], ["i_upd"])
    hx = add("Add", "/cell/Add_hx", [ng, upd], ["hx"])

    # decoder: concat(h, smear) -> ConvTranspose; all but the last level
    # relu + concat the matching encoder skip (gruunet cell, reference
    # gruunet2.py:184-198)
    h = hx
    for i in range(levels):
        sm = f"smear_up{i}"
        inits[sm] = _buf(cell, f"smear_up{i}")[None]
        cat = add("Concat", f"/cell/output_gate/ups.{i}/Concat_smear",
                  [h, sm], [f"og_in{i}"], axis=1)
        wname = f"cell.output_gate.ups.{i}.conv.weight"
        bname = f"cell.output_gate.ups.{i}.conv.bias"
        inits[wname] = np.asarray(params[wname], np.float32)
        inits[bname] = np.asarray(params[bname], np.float32)
        conv = add("ConvTranspose", f"/cell/output_gate/ups.{i}/conv/"
                   "ConvTranspose",
                   [cat, wname, bname], [f"og_conv{i}"],
                   strides=[int(c.strides[::-1][i])],
                   pads=[int(c.paddings[::-1][i])] * 2,
                   output_padding=[int(cell.up_output_paddings[i])],
                   kernel_shape=[int(c.kernel_sizes[::-1][i])])
        if i != levels - 1:
            act = add("Relu", f"/cell/output_gate/ups.{i}/Relu", [conv],
                      [f"og_act{i}"])
            h = add("Concat", f"/cell/output_gate/ups.{i}/Concat",
                    [act, skip_names[levels - 1 - i]],
                    [f"og_cat{i}"], axis=1)
        else:
            h = conv
    add("Squeeze", "/cell/Squeeze_out", [h], ["output"], axes=[1])

    graph = Graph(nodes, inits,
                  [("input", (1, F)), ("h0", (1, hidden, cell.compressed))],
                  ["output", "hx"])
    return write_onnx(graph, path,
                      output_shapes={"output": (1, F),
                                     "hx": (1, hidden, cell.compressed)})


def export_cell(model, path: str) -> str:
    """Export ``model`` by its class: a MOMO2/MOMO3 or GRUUNet2/GRUUNet
    cell step, TRUNet's core forward, or a stateless U-Net's whole
    segment forward (it has no cell)."""
    from audio_denoising_torch.models import (
        GRUUNet2, MOMO3, TRUNet, UNet2d)
    if isinstance(model, MOMO3):                   # MOMO3 and MOMO2
        return export_momo_cell(model, path)
    if isinstance(model, GRUUNet2):                # GRUUNet2, GRUUNet
        return export_gruunet_cell(model, path)
    if isinstance(model, TRUNet):                  # TRUNetDenoiser too
        return export_trunet(model, path)
    if isinstance(model, UNet2d):
        return export_unet2d(model, path)
    raise ValueError(
        f"ONNX export supports the MOMO/GRUUNet recurrent families, the "
        f"stateless UNet2d family and TRUNet; got {type(model).__name__}")


# -- stateless UNet2d export -------------------------------------------------

def export_unet2d(model, path: str, frames: int = None) -> str:
    """Export a UNet2d-family forward (models/unet2d.py apply, reference
    unet4.py:147-194) to ONNX.

    The graph is the whole segment model (there is no recurrence/cell):
    input ``input`` (1, bins, T) log-magnitude -> output ``output``
    (1, bins', T') residual, inference semantics (dropout identity,
    InstanceNorm with batch statistics — affine=False becomes
    scale=1/bias=0 initializers). ``frames`` fixes T at export (ONNX
    shapes here are static, like the reference's batch-1 artifacts); it
    must be a ``compatible_frames`` value — defaults to the smallest
    valid count ≥ 48.
    """
    if frames is None:
        frames = model.compatible_frames(48)
    else:
        assert model.compatible_frames(frames) == frames, (
            f"frames={frames} is not accepted by {model.arch}'s fixed "
            f"output_padding decoder (nearest valid: "
            f"{model.compatible_frames(frames)})")
    params = _params(model)
    bins, t = model.bins, frames

    nodes: List[Node] = []
    inits: Dict[str, np.ndarray] = {}

    def add(op, name, ins, outs, **attrs):
        nodes.append(Node(op, name, tuple(ins), tuple(outs), attrs))
        return outs[0]

    def block(x_name, layer, w, b, slope, norm, stride, op_pad, kernel,
              transpose):
        """Conv/ConvTranspose -> [InstanceNormalization] -> PRelu, the
        reference block grammar (unet4.py:211-248)."""
        inits[w] = np.asarray(params[w], np.float32)
        inits[b] = np.asarray(params[b], np.float32)
        kh, kw = kernel
        if transpose:
            conv = add("ConvTranspose", f"/{layer}/conv/ConvTranspose",
                       [x_name, w, b], [f"{layer}_conv"],
                       strides=list(stride), pads=[1, 1, 1, 1],
                       output_padding=list(op_pad), kernel_shape=[kh, kw])
            c_out = inits[w].shape[1]
        else:
            conv = add("Conv", f"/{layer}/conv/Conv", [x_name, w, b],
                       [f"{layer}_conv"], strides=list(stride),
                       pads=[1, 1, 1, 1], kernel_shape=[kh, kw])
            c_out = inits[w].shape[0]
        h = conv
        if norm:
            inits[f"{layer}_scale"] = np.ones(c_out, np.float32)
            inits[f"{layer}_shift"] = np.zeros(c_out, np.float32)
            h = add("InstanceNormalization", f"/{layer}/InstanceNorm",
                    [h, f"{layer}_scale", f"{layer}_shift"],
                    [f"{layer}_norm"], epsilon=1e-5)
        inits[slope] = np.asarray(params[slope], np.float32)
        return add("PRelu", f"/{layer}/PRelu", [h, slope],
                   [f"{layer}_act"]), c_out

    def _pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    # (1, bins, T) -> (1, 1, bins, T), concat the positional smearing
    # field (baked at the fixed T; the reference re-broadcasts per call,
    # unet4.py:158)
    x = add("Unsqueeze", "/Unsqueeze_x", ["input"], ["x_img"], axes=[1])
    inits["smear"] = np.broadcast_to(
        _buf(model, "smear")[None, :, :, None],
        (1, model.chnls_gs, bins, t)).copy()
    h = add("Concat", "/Concat_smear", [x, "smear"], ["x_in"], axis=1)

    encs = []
    for (name, _ci, _co, k, s, norm) in model.spec["downs"]:
        h, _ = block(h, name, f"{name}.layers.0.weight",
                     f"{name}.layers.0.bias",
                     f"{name}.layers.{2 if norm else 1}.weight",
                     norm, _pair(s), (0, 0), _pair(k), transpose=False)
        encs.append(h)

    n_down = len(encs)
    h = encs[-1]
    for i, (name, _ci, _co, k, s, op_) in enumerate(model.spec["ups"]):
        h, _ = block(h, name, f"{name}.layers.0.weight",
                     f"{name}.layers.0.bias", f"{name}.layers.2.weight",
                     True, _pair(s), _pair(op_), _pair(k), transpose=True)
        h = add("Concat", f"/{name}/Concat_skip",
                [h, encs[n_down - 2 - i]], [f"{name}_cat"], axis=1)

    name, _ci, k, s, op_ = model.spec["final"]
    inits[f"{name}.weight"] = np.asarray(params[f"{name}.weight"],
                                         np.float32)
    inits[f"{name}.bias"] = np.asarray(params[f"{name}.bias"], np.float32)
    kh, kw = _pair(k)
    h = add("ConvTranspose", f"/{name}/conv/ConvTranspose",
            [h, f"{name}.weight", f"{name}.bias"], ["final_conv"],
            strides=list(_pair(s)), pads=[1, 1, 1, 1],
            output_padding=list(_pair(op_)), kernel_shape=[kh, kw])
    add("Squeeze", "/Squeeze_out", [h], ["output"], axes=[1])

    out_bins, out_t = model._round_trip(bins, t)
    graph = Graph(nodes, inits, [("input", (1, bins, t))], ["output"])
    return write_onnx(graph, path,
                      output_shapes={"output": (1, out_bins, out_t)})


# -- TRUNet export -----------------------------------------------------------

def export_trunet(model, path: str, bins: int = None) -> str:
    """Export the TRUNet core forward (models/trunet.py apply; vendored
    reference model trunet.py:122-158) to ONNX: ``input`` (1, 4, bins) ->
    ``output`` (1, 5, bins), the contract the reference's own smoke test
    defines (trunet.py:160-168). Completes the writer's zoo coverage —
    depthwise convs ride Conv ``group``, BatchNorm rides inference-mode
    BatchNormalization, the F/T GRU blocks ride the ONNX ``GRU`` op with
    ``linear_before_reset=1`` (the torch GRU semantics; torch's r,z,n
    gate packing is reordered to ONNX's z,r,h at export).

    ``model`` may be the TRUNet core or the TRUNetDenoiser adapter (the
    adapter's featurization is framework-side, not part of the artifact).
    """
    params = _params(model)
    net = model
    if bins is None:
        bins = getattr(model, "num_bins", 257)

    nodes: List[Node] = []
    inits: Dict[str, np.ndarray] = {}

    def add(op, name, ins, outs, **attrs):
        nodes.append(Node(op, name, tuple(ins), tuple(outs), attrs))
        return outs[0]

    def put(name):
        inits[name] = np.asarray(params[name], np.float32)
        return name

    def bn(x, name, tag, ch_len):
        for suf in ("weight", "bias", "running_mean", "running_var"):
            put(f"{name}.{suf}")
        return add("BatchNormalization", f"/{tag}/BatchNorm",
                   [x, f"{name}.weight", f"{name}.bias",
                    f"{name}.running_mean", f"{name}.running_var"],
                   [f"{tag}_bn"], epsilon=1e-5)

    def relu(x, tag):
        return add("Relu", f"/{tag}/Relu", [x], [f"{tag}_act"])

    def conv(x, wname, tag, k, s, p, group=1):
        put(wname + ".weight")
        put(wname + ".bias")
        return add("Conv", f"/{tag}/Conv",
                   [x, wname + ".weight", wname + ".bias"], [f"{tag}_conv"],
                   strides=[s], pads=[p, p], kernel_shape=[k], group=group)

    def convT(x, wname, tag, k, s, p):
        put(wname + ".weight")
        put(wname + ".bias")
        return add("ConvTranspose", f"/{tag}/ConvTranspose",
                   [x, wname + ".weight", wname + ".bias"], [f"{tag}_convt"],
                   strides=[s], pads=[p, p], output_padding=[0],
                   kernel_shape=[k])

    def conv_len(L, k, s, p):
        return (L + 2 * p - k) // s + 1

    # ---- encoder (sizes tracked statically; bins=257 -> ... -> 17) ----
    x = "input"
    L = bins
    skips = []                        # [(name, channels, length)]
    (name, cin, cout, k, s, _kind) = net.DOWNS[0]
    x = conv(x, f"{name}.StandardConv1d.0", name, k, s, s // 2)
    x = relu(x, name)
    L = conv_len(L, k, s, s // 2)
    skips.append((x, cout, L))
    for (name, cin, cout, k, s, _kind) in net.DOWNS[1:]:
        seq = f"{name}.DepthwiseSeparableConv1d"
        x = conv(x, f"{seq}.0", f"{name}_pw", 1, 1, 0)
        x = relu(bn(x, f"{seq}.1", f"{name}_pw", cout), f"{name}_pw")
        x = conv(x, f"{seq}.3", f"{name}_dw", k, s, k // 2, group=cout)
        x = relu(bn(x, f"{seq}.4", f"{name}_dw", cout), f"{name}_dw")
        L = conv_len(L, k, s, k // 2)
        skips.append((x, cout, L))

    def pack_gru(prefix, n_dir, hidden, in_sz, tag):
        """torch (r,z,n) -> ONNX (z,r,h) packing as W/R/B initializers."""
        Ws, Rs, Bs = [], [], []
        for d in range(n_dir):
            sfx = "_reverse" if d == 1 else ""
            w_ih = np.asarray(params[f"{prefix}weight_ih_l0{sfx}"],
                              np.float32)
            w_hh = np.asarray(params[f"{prefix}weight_hh_l0{sfx}"],
                              np.float32)
            b_ih = np.asarray(params[f"{prefix}bias_ih_l0{sfx}"],
                              np.float32)
            b_hh = np.asarray(params[f"{prefix}bias_hh_l0{sfx}"],
                              np.float32)
            H = hidden
            zrh = lambda m: np.concatenate([m[H:2 * H], m[:H], m[2 * H:]])
            Ws.append(zrh(w_ih))
            Rs.append(zrh(w_hh))
            Bs.append(np.concatenate([zrh(b_ih), zrh(b_hh)]))
        inits[f"{tag}_W"] = np.stack(Ws)
        inits[f"{tag}_R"] = np.stack(Rs)
        inits[f"{tag}_B"] = np.stack(Bs)
        return f"{tag}_W", f"{tag}_R", f"{tag}_B"

    # ---- FGRU: bidirectional over the compressed frequency axis ----
    # x: (1, 128, L) -> GRU X (L, 1, 128)
    xg = add("Transpose", "/FGRU/Transpose_in", [x], ["fgru_x"],
             perm=[2, 0, 1])
    fgru, tgru = net.FGRU.GRU, net.TGRU.GRU
    Wn, Rn, Bn = pack_gru("FGRU.GRU.", 2, fgru.hidden_size,
                          fgru.input_size, "fgru")
    nodes.append(Node("GRU", "/FGRU/GRU", (xg, Wn, Rn, Bn),
                      ("fgru_Y", "fgru_Yh"),
                      {"hidden_size": fgru.hidden_size,
                       "direction": "bidirectional",
                       "linear_before_reset": 1}))
    # Y (L, 2, 1, 64) -> (1, L, 128) -> (1, 128, L): torch's
    # bidirectional output concatenates the directions on the feature
    # axis, which the (L, 2*64) reshape reproduces exactly
    y = add("Transpose", "/FGRU/Transpose_y", ["fgru_Y"], ["fgru_yt"],
            perm=[2, 0, 1, 3])
    inits["fgru_shape"] = np.asarray([1, L, 2 * fgru.hidden_size],
                                     np.int64)
    y = add("Reshape", "/FGRU/Reshape", [y, "fgru_shape"], ["fgru_flat"])
    y = add("Transpose", "/FGRU/Transpose_out", [y], ["fgru_img"],
            perm=[0, 2, 1])
    y = conv(y, "FGRU.conv.0", "FGRU_c", 1, 1, 0)
    x = relu(bn(y, "FGRU.conv.1", "FGRU_c", 64), "FGRU_c")

    # ---- TGRU: unidirectional over the same axis ----
    xg = add("Transpose", "/TGRU/Transpose_in", [x], ["tgru_x"],
             perm=[2, 0, 1])
    Wn, Rn, Bn = pack_gru("TGRU.GRU.", 1, tgru.hidden_size,
                          tgru.input_size, "tgru")
    nodes.append(Node("GRU", "/TGRU/GRU", (xg, Wn, Rn, Bn),
                      ("tgru_Y", "tgru_Yh"),
                      {"hidden_size": tgru.hidden_size,
                       "direction": "forward",
                       "linear_before_reset": 1}))
    inits["tgru_shape"] = np.asarray([L, tgru.hidden_size], np.int64)
    y = add("Reshape", "/TGRU/Reshape", ["tgru_Y", "tgru_shape"],
            ["tgru_flat"])
    y = add("Transpose", "/TGRU/Transpose_y", [y], ["tgru_t"], perm=[1, 0])
    y = add("Unsqueeze", "/TGRU/Unsqueeze", [y], ["tgru_img"], axes=[0])
    y = conv(y, "TGRU.conv.0", "TGRU_c", 1, 1, 0)
    x = relu(bn(y, "TGRU.conv.1", "TGRU_c", 64), "TGRU_c")

    # ---- decoder with pad/crop skip concats (trunet.py:95-98) ----
    def pad_cat(x, x_len, skip, skip_ch, skip_len, ch, tag):
        """Match x's length to the skip's (F.pad semantics: negative pads
        crop), then concat channels."""
        diff = skip_len - x_len
        left, right = diff // 2, diff - diff // 2
        if left < 0 or right < 0:
            inits[f"{tag}_starts"] = np.asarray([max(0, -left)], np.int64)
            inits[f"{tag}_ends"] = np.asarray([x_len - max(0, -right)],
                                              np.int64)
            inits[f"{tag}_axes"] = np.asarray([2], np.int64)
            x = add("Slice", f"/{tag}/Slice",
                    [x, f"{tag}_starts", f"{tag}_ends", f"{tag}_axes"],
                    [f"{tag}_crop"])
            x_len = x_len - max(0, -left) - max(0, -right)
            left, right = max(0, left), max(0, right)
        parts = [x]
        if left > 0:
            inits[f"{tag}_zl"] = np.zeros((1, ch, left), np.float32)
            parts = [f"{tag}_zl"] + parts
        if right > 0:
            inits[f"{tag}_zr"] = np.zeros((1, ch, right), np.float32)
            parts = parts + [f"{tag}_zr"]
        if len(parts) > 1:
            x = add("Concat", f"/{tag}/Concat_pad", parts, [f"{tag}_pad"],
                    axis=2)
        return add("Concat", f"/{tag}/Concat_skip", [x, skip],
                   [f"{tag}_cat"], axis=1), skip_len

    for i, (name, cin, cout, k, s, kind) in enumerate(net.UPS):
        seq = f"{name}.{kind}"
        if kind != "FirstTrCNN":
            skip, skip_ch, skip_len = skips[len(net.UPS) - 1 - i]
            x, L = pad_cat(x, L, skip, skip_ch, skip_len,
                           cin - skip_ch, name)
        x = conv(x, f"{seq}.0", f"{name}_pw", 1, 1, 0)
        x = relu(bn(x, f"{seq}.1", f"{name}_pw", cout), f"{name}_pw")
        x = convT(x, f"{seq}.3", f"{name}_tr", k, s, s // 2)
        L = (L - 1) * s - 2 * (s // 2) + k
        if kind != "LastTrCNN":
            x = relu(bn(x, f"{seq}.4", f"{name}_tr", cout), f"{name}_tr")
    add("Identity", "/output", [x], ["output"])

    graph = Graph(nodes, inits, [("input", (1, 4, bins))], ["output"])
    return write_onnx(graph, path, output_shapes={"output": (1, 5, L)})


# -- MOMO cell export ------------------------------------------------------

def export_momo_cell(model, path: str) -> str:
    """Export one MOMO2/MOMO3 cell step (models/momo.py) to ONNX.

    Inputs: ``input`` (1, F) [+ ``prev`` (1, F) for delta models],
    ``h0`` (1, hidden, compressed). Outputs: ``output`` (1, F), ``hx``
    (momo2_02-style explicit state IO). Batch 1 like the reference
    artifacts.
    """
    params = _params(model)
    c = model.config
    geo = model.cell
    F = model.num_bins
    delta = model.delta

    nodes: List[Node] = []
    inits: Dict[str, np.ndarray] = {}

    def add(op, name, ins, outs, **attrs):
        nodes.append(Node(op, name, tuple(ins), tuple(outs), attrs))
        return outs[0]

    # x image (1, C_in, F)
    x2 = add("Unsqueeze", "/cell/Unsqueeze_x", ["input"],
             ["x_img"], axes=[1])
    if delta:
        d = add("Sub", "/cell/Sub_delta", ["input", "prev"], ["delta"])
        d2 = add("Unsqueeze", "/cell/Unsqueeze_delta", [d], ["delta_img"],
                 axes=[1])
        xin = add("Concat", "/cell/Concat_xin", [x2, d2], ["xin"], axis=1)
    else:
        xin = x2

    inits["smear_in"] = _buf(geo, "smear_in")[None]
    inits["smear_hx"] = _buf(geo, "smear_hx")[None]

    h = add("Concat", "/cell/input_gate/Concat", [xin, "smear_in"],
            ["ig_in"], axis=1)
    for i in range(geo.levels):
        wname = f"cell.input_gate.downs.{i}.conv.weight"
        bname = f"cell.input_gate.downs.{i}.conv.bias"
        inits[wname] = np.asarray(params[wname], np.float32)
        inits[bname] = np.asarray(params[bname], np.float32)
        conv = add("Conv", f"/cell/input_gate/downs.{i}/conv/Conv",
                   [h, wname, bname], [f"ig_conv{i}"],
                   strides=[int(c.strides[i])],
                   pads=[int(c.paddings[i])] * 2,
                   kernel_shape=[int(c.kernel_sizes[i])])
        h = add("Relu", f"/cell/input_gate/downs.{i}/Relu", [conv],
                [f"ig_act{i}"])
    skip_names = ["ig_in"] + [f"ig_act{i}" for i in range(geo.levels - 1)]

    hcat = add("Concat", "/cell/reset_gate/Concat", ["h0", "smear_hx"],
               ["rg_in"], axis=1)
    inits["cell.reset_gate.downs.0.conv.weight"] = np.asarray(
        params["cell.reset_gate.downs.0.conv.weight"], np.float32)
    inits["cell.reset_gate.downs.0.conv.bias"] = np.asarray(
        params["cell.reset_gate.downs.0.conv.bias"], np.float32)
    rg = add("Conv", "/cell/reset_gate/downs.0/conv/Conv",
             [hcat, "cell.reset_gate.downs.0.conv.weight",
              "cell.reset_gate.downs.0.conv.bias"], ["rg_conv"],
             strides=[1], pads=[1, 1], kernel_shape=[3])
    rg = add("Relu", "/cell/reset_gate/downs.0/Relu", [rg], ["rg_act"])

    hidden = geo.hidden
    nodes.append(Node("Split", "/cell/Split_i",
                      (f"ig_act{geo.levels - 1}",),
                      ("i_r", "i_i", "i_n"),
                      {"axis": 1, "split": [hidden] * 3}))
    nodes.append(Node("Split", "/cell/Split_h", (rg,),
                      ("h_r", "h_i", "h_n"),
                      {"axis": 1, "split": [hidden] * 3}))
    ig = add("Add", "/cell/Add_i", ["i_i", "h_i"], ["pre_ig"])
    ig = add("Sigmoid", "/cell/Sigmoid", [ig], ["inputgate"])
    rgate = add("Add", "/cell/Add_r", ["i_r", "h_r"], ["pre_rg"])
    rgate = add("Sigmoid", "/cell/Sigmoid_1", [rgate], ["resetgate"])
    rn = add("Mul", "/cell/Mul_rn", [rgate, "h_n"], ["r_hn"])
    ng = add("Add", "/cell/Add_n", ["i_n", rn], ["pre_ng"])
    ng = add("Tanh", "/cell/Tanh", [ng], ["newgate"])
    hdiff = add("Sub", "/cell/Sub_h", ["h0", ng], ["h_minus_n"])
    upd = add("Mul", "/cell/Mul_upd", [ig, hdiff], ["i_upd"])
    hx = add("Add", "/cell/Add_hx", [ng, upd], ["hx"])

    h = hx
    for i in range(geo.levels):
        wname = f"cell.output_gate.ups.{i}.conv.weight"
        bname = f"cell.output_gate.ups.{i}.conv.bias"
        inits[wname] = np.asarray(params[wname], np.float32)
        inits[bname] = np.asarray(params[bname], np.float32)
        k = int(c.kernel_sizes[::-1][i])
        conv = add("ConvTranspose", f"/cell/output_gate/ups.{i}/conv/"
                   "ConvTranspose",
                   [h, wname, bname], [f"og_conv{i}"],
                   strides=[int(c.strides[::-1][i])],
                   pads=[int(c.paddings[::-1][i])] * 2,
                   output_padding=[int(geo.up_output_paddings[i])],
                   kernel_shape=[k])
        if i != geo.levels - 1:
            act = add("Relu", f"/cell/output_gate/ups.{i}/Relu", [conv],
                      [f"og_act{i}"])
            h = add("Concat", f"/cell/output_gate/ups.{i}/Concat",
                    [act, skip_names[geo.levels - 1 - i]],
                    [f"og_cat{i}"], axis=1)
        else:
            h = conv
    add("Squeeze", "/cell/Squeeze_out", [h], ["output"], axes=[1])

    inputs = [("input", (1, F))]
    if delta:
        inputs.append(("prev", (1, F)))
    inputs.append(("h0", (1, hidden, geo.compressed)))
    graph = Graph(nodes, inits, inputs, ["output", "hx"])
    return write_onnx(graph, path,
                      output_shapes={"output": (1, F),
                                     "hx": (1, hidden, geo.compressed)})
