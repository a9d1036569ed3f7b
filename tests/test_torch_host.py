"""The port's own host layer against the reference's: every copied table,
the parameter validation, the SPS/PPS/SEI bytes, the two-pass rate
control, zones, forced frame types, the access-unit log and the close()
summary are the same as in x264_tpu, and no module of the port (nor
chip_smoke.py) imports x264_tpu."""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

# a compile cache per xdist worker: the shared one has crashed a worker
os.environ.setdefault("X264_TPU_JAX_CACHE", os.path.join(
    tempfile.gettempdir(),
    f"x264_tpu_jax_{os.environ.get('PYTEST_XDIST_WORKER', 'main')}"))
pytest.importorskip("jax")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
import x264_tpu.params as r_params  # noqa: E402
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
import x264_tpu.bitstream.bits as r_bits  # noqa: E402
from x264_tpu.bitstream import cabac_host as r_cabac_host  # noqa: E402
from x264_tpu.bitstream import cabac_init as r_cabac_init  # noqa: E402
from x264_tpu.bitstream import nal as r_nal  # noqa: E402
from x264_tpu.bitstream import sei as r_sei  # noqa: E402
from x264_tpu.bitstream import slice_assemble as r_sa  # noqa: E402
from x264_tpu.bitstream import tables as r_tables  # noqa: E402
from x264_tpu.models import inter_device as r_inter_device  # noqa: E402
from x264_tpu.models import inter_frame as r_inter  # noqa: E402
from x264_tpu.models import mbtree as r_mbtree  # noqa: E402
from x264_tpu.models import weightp as r_weightp  # noqa: E402
from x264_tpu.models import residual_device as r_residual  # noqa: E402
from x264_tpu.ops.device import me_parts as r_me_parts  # noqa: E402
from x264_tpu.ops.reference import deblock as r_deblock  # noqa: E402
from x264_tpu.ops.reference import mc as r_mc  # noqa: E402
from x264_tpu.rc import ratecontrol as r_rc  # noqa: E402
from x264_tpu.utils import yuv as r_yuv  # noqa: E402
from x264_tpu.utils.yuv import Frame420 as RefFrame  # noqa: E402
import x264_tpu_torch.params as t_params  # noqa: E402
from x264_tpu_torch import state  # noqa: E402
import x264_tpu_torch.bitstream.bits as t_bits  # noqa: E402
from x264_tpu_torch.bitstream import cabac_init as t_cabac_init  # noqa: E402
from x264_tpu_torch.bitstream import nal as t_nal  # noqa: E402
from x264_tpu_torch.bitstream import sei as t_sei  # noqa: E402
from x264_tpu_torch.bitstream import slice_assemble as t_sa  # noqa: E402
from x264_tpu_torch.bitstream import tables as t_tables  # noqa: E402
from x264_tpu_torch.api import Encoder  # noqa: E402
from x264_tpu_torch.models import inter as t_inter  # noqa: E402
from x264_tpu_torch.models import mbtree as t_mbtree  # noqa: E402
from x264_tpu_torch.models import weightp as t_weightp  # noqa: E402
from x264_tpu_torch.ops import entropy_pack as t_entropy_pack  # noqa: E402
from x264_tpu_torch.ops import me_parts as t_me_parts  # noqa: E402
from x264_tpu_torch.rc import ratecontrol as t_rc  # noqa: E402
from x264_tpu_torch.utils import yuv as t_yuv  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TABLES = [
    ("CHROMA_QP_TABLE", r_tables, state),
    ("QUANT4_MF", r_tables, state),
    ("DEQUANT4", r_tables, state),
    ("ZIGZAG_4x4", r_tables, state),
    ("ZIGZAG_8x8", r_tables, state),
    ("QUANT8_MF", r_tables, state),
    ("DEQUANT8", r_tables, state),
    ("_DS4", r_residual, state),
    ("_DS8", r_residual, state),
    ("CTX_INIT_I", r_cabac_init, t_cabac_init),
    ("CTX_INIT_PB", r_cabac_init, t_cabac_init),
    ("SIG8X8_MAP", r_cabac_init, t_cabac_init),
    ("LAST8X8_MAP", r_cabac_init, t_cabac_init),
    ("ALPHA", r_deblock, state),
    ("BETA", r_deblock, state),
    ("TC0", r_deblock, state),
    ("QPEL_TWO_SAMPLE_TBL", r_mc, state),
    ("PAD", r_inter, state),
    ("PART_OF_QUAD", r_me_parts, t_me_parts),
    ("FIRST_QUAD", r_me_parts, t_me_parts),
    ("N_PARTS", r_me_parts, t_me_parts),
    ("SHAPE_BITS", r_me_parts, t_me_parts),
    ("LOG2_DENOM", r_weightp, t_weightp),
    ("NEUTRAL", r_weightp, t_weightp),
    ("COEFF_TOKEN_VAL", r_tables, t_tables),
    ("COEFF_TOKEN_LEN", r_tables, t_tables),
    ("TOTAL_ZEROS_VAL", r_tables, t_tables),
    ("TOTAL_ZEROS_LEN", r_tables, t_tables),
    ("TZ_2x2_VAL", r_tables, t_tables),
    ("TZ_2x2_LEN", r_tables, t_tables),
    ("TZ_2x4_VAL", r_tables, t_tables),
    ("TZ_2x4_LEN", r_tables, t_tables),
    ("RUN_BEFORE_VAL", r_tables, t_tables),
    ("RUN_BEFORE_LEN", r_tables, t_tables),
    ("CBP_TO_GOLOMB", r_tables, t_tables),
]


def test_cabac_init_is_a_verbatim_copy():
    """bitstream/cabac_init.py (generated tables) is the reference's file
    byte for byte."""
    with open(t_cabac_init.__file__, "rb") as a, \
            open(r_cabac_init.__file__, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name,ref_mod,port_mod", TABLES,
                         ids=[t[0] for t in TABLES])
def test_copied_table_equals_reference(name, ref_mod, port_mod):
    a, b = getattr(port_mod, name), getattr(ref_mod, name)
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(a, b)


# host functions the port copies verbatim: (name, reference module, port
# module)
FUNCTIONS = [
    ("weight_cost", r_weightp, t_weightp),
    ("_mc_pairs", r_weightp, t_weightp),
    ("analyse_weights", r_weightp, t_weightp),
    ("_te_ref_bits", r_inter_device, t_inter),
    ("_pack_ct", r_tables, t_tables),
    ("_pack_rect", r_tables, t_tables),
    ("merge_mb_strings", r_sa, t_sa),
    ("split_annexb", r_nal, t_nal),
    ("append_payload", r_sa, t_sa),
    ("aq_offsets", r_rc, t_rc),
    ("propagate", r_mbtree, t_mbtree),
    ("_splat", r_mbtree, t_mbtree),
    ("finish", r_mbtree, t_mbtree),
    ("expand_offsets", r_mbtree, t_mbtree),
    ("expand_offsets8", r_mbtree, t_mbtree),
]


def _mbtree_window(rng, k, mbw, mbh):
    """(ics, pcs, mvs) of a k-frame lowres window, MB-tree's inputs."""
    n = mbw * mbh
    ics = [rng.integers(1, 3000, n) for _ in range(k)]
    pcs = [None] + [rng.integers(0, 3000, n) for _ in range(k - 1)]
    mvs = [None] + [rng.integers(-40, 41, (n, 2)).astype(np.int32)
                    for _ in range(k - 1)]
    return ics, pcs, mvs


def _written(fn, writer):
    """append_payload as a function of its payload: the bytes it leaves
    in a fresh writer."""
    def run(*a):
        bs = writer()
        fn(bs, *a)
        return np.frombuffer(bs.to_rbsp(), np.uint8)
    return run


@pytest.mark.parametrize("name,ref_mod,port_mod", FUNCTIONS,
                         ids=[f[0] for f in FUNCTIONS])
def test_copied_function_equals_reference(name, ref_mod, port_mod):
    """The same source text (docstrings aside: a copy may name its
    origin), and the same results on a fading pan and on noise."""
    def code(fn):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        body = tree.body[0].body
        if isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant):
            tree.body[0].body = body[1:]
        return ast.dump(tree)

    port_fn, ref_fn = getattr(port_mod, name), getattr(ref_mod, name)
    assert code(port_fn) == code(ref_fn)
    if name == "append_payload":
        port_fn = _written(port_fn, t_bits.BitWriter)
        ref_fn = _written(ref_fn, r_bits.BitWriter)
    rng = np.random.default_rng(5)
    tex = rng.integers(0, 200, (80, 100)).astype(np.uint8)
    cur = np.clip(tex[4:52, 6:70] * 0.85 - 6, 0, 255).astype(np.uint8)
    refs = [tex[2:50, 3:67], tex[:48, :64],
            rng.integers(0, 256, (48, 64)).astype(np.uint8)]
    yuv = (tex[:48, :96], tex[48:72, :48], tex[56:80, 50:98])
    args = {"weight_cost": [(cur.astype(np.int64), r.astype(np.int64),
                             w, off) for r in refs
                            for w, off in ((64, 0), (54, -6))],
            "_mc_pairs": [(cur, r) for r in refs],
            "analyse_weights": [(cur, refs[:k]) for k in (1, 2, 3)],
            "_te_ref_bits": [(k,) for k in range(1, 6)],
            "_pack_ct": [()],
            "_pack_rect": [(r_tables._TZ, 15, 16), (r_tables._RB, 7, 15)],
            "split_annexb": [(b"\x00\x00\x00\x01\x67\x42\x00\x00\x01"
                              b"\x68\xce\x00\x00\x03\x00\x00\x01\x65\x88"
                              b"\x00",)],
            "merge_mb_strings": [
                (rng.integers(0, 1 << 32, (6, 8), dtype=np.uint64)
                 .astype(np.uint32), rng.integers(0, 257, 6))
                for _ in range(3)],
            "append_payload": [
                (rng.integers(0, 1 << 32, 9, dtype=np.uint64)
                 .astype(np.uint32), t) for t in (0, 31, 32, 200, 288)],
            "aq_offsets": [(*yuv, 6, 3, s, m) for m in (1, 2, 3)
                           for s in (0.6, 1.0, 1.4)],
            "propagate": [(*_mbtree_window(rng, k, 6, 4), 6, 4, bs)
                          for k in (2, 5) for bs in (8, 16)],
            "_splat": [(rng.random(20) * 900, rng.integers(
                -70, 71, (20, 2)).astype(np.int32), 5, 4, bs)
                for bs in (8, 16)],
            "finish": [(rng.integers(0, 3000, 24), rng.random(24) * 5000,
                        s) for s in (None, 1.0)],
            "expand_offsets": [(rng.random(6) - 0.5, 3, 2, 7, 5)],
            "expand_offsets8": [(rng.random(12) - 0.5, 4, 3, 5, 4)],
            }[name]
    for a in args:
        got, want = port_fn(*a), ref_fn(*a)
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(got, want)


# the live slice's host code: the SEI writers and the encoder's VBV,
# HRD, refresh and entry-point methods, copied but for the import lines
# (the port imports at the module's head)
LIVE_COPIES = [("_payload_bytes", r_sei, t_sei),
               ("buffering_period_sei", r_sei, t_sei),
               ("pic_timing_sei", r_sei, t_sei),
               ("recovery_point_sei", r_sei, t_sei)] + [
    (name, RefEncoder, Encoder)
    for name in ("_pir_w", "_pir_args", "intra_refresh",
                 "invalidate_reference", "_hrd_sei", "_vbv_retry_qp",
                 "delayed_frames", "encode_pipelined", "_decide_type")]


class _DropImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import


@pytest.mark.parametrize("name,ref_obj,port_obj", LIVE_COPIES,
                         ids=[c[0] for c in LIVE_COPIES])
def test_live_copies_equal_reference(name, ref_obj, port_obj):
    """The same source text, docstrings and import statements aside."""
    def code(fn):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        body = tree.body[0].body
        if isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant):
            tree.body[0].body = body[1:]
        return ast.dump(_DropImports().visit(tree))

    assert code(getattr(port_obj, name)) == code(getattr(ref_obj, name))


@pytest.mark.parametrize("delay", [0, 1, 8100, 90000, 1 << 24, 1 << 30])
def test_sei_bytes_equal_reference(delay):
    """Buffering-period, pic-timing and recovery-point SEIs byte for byte,
    the 24-bit fields clamped alike."""
    assert t_sei.buffering_period_sei(delay) == \
        r_sei.buffering_period_sei(delay)
    assert t_sei.buffering_period_sei(delay, delay // 3) == \
        r_sei.buffering_period_sei(delay, delay // 3)
    assert t_sei.pic_timing_sei(delay, 2 * delay) == \
        r_sei.pic_timing_sei(delay, 2 * delay)
    n = delay % 300
    assert t_sei.recovery_point_sei(n) == r_sei.recovery_point_sei(n)


def test_lambda_and_mv_bits_equal_reference():
    for qp in range(52):
        assert state.sad_lambda(qp) == r_inter.sad_lambda(qp)
        assert state.me_lambda(qp) == r_inter.me_lambda(qp)
    for m in (4, 36, 64, 132):
        np.testing.assert_array_equal(state.mv_bits_arr(m),
                                      r_inter.mv_bits_arr(m))


PARAMS = [
    dict(cabac=True),
    dict(cabac=True, p8x8=True, me_range=8),
    dict(width=350, height=286, cabac=True, qp=40, deblock_alpha=-2,
         deblock_beta=3, chroma_qp_offset=2),
    dict(cabac=True, rc_method=r_params.RC_CRF, crf=20.0, keyint_max=60,
         sar_width=16, sar_height=11, fullrange=True),
    dict(cabac=True, p8x8=True, subpel=0),       # validate drops p8x8
    dict(cabac=True, sei_version=False, deblock=False, level_idc=40),
]


@pytest.mark.parametrize("kw", PARAMS)
def test_params_and_headers_equal_reference(kw):
    """The port's validate() gives the same fields as the reference's, and
    its encoder writes the same SPS, PPS and version SEI bytes."""
    rp = r_params.EncoderParams(**kw).validate()
    tp = t_params.EncoderParams(**kw).validate()
    assert dataclasses.asdict(tp) == dataclasses.asdict(rp)
    assert Encoder(t_params.EncoderParams(**kw), device="cpu").headers() \
        == RefEncoder(r_params.EncoderParams(**kw)).headers()


@pytest.mark.parametrize("kw", [dict(p8x8=True, slices=2),
                                dict(p8x8=True, backend="reference"),
                                dict(i16x16=False),
                                dict(nal_hrd=True)])
def test_validate_rejects_like_reference(kw):
    with pytest.raises(Exception) as ref_err:
        r_params.EncoderParams(**kw).validate()
    with pytest.raises(type(ref_err.value)) as port_err:
        t_params.EncoderParams(**kw).validate()
    assert str(port_err.value) == str(ref_err.value)


# the CLI's modules, copied but for their import lines and module
# docstrings (a copy names its origin)
CLI_MODULES = ["__main__.py", "output/__init__.py", "output/mux.py",
               "utils/y4m.py", "utils/filters.py", "utils/metrics.py"]

# what the port's CLI changes, each (port text, reference text): its
# program name, --device and the recon planes it reads back from the
# device; everything else is the reference's
CLI_CHANGES = [
    ('prog="x264_tpu_torch"', 'prog="x264_tpu"'),
    ('description="H.264 encoder on PyTorch + CUDA (x264_tpu\'s port)"',
     'description="TPU-native H.264 encoder (x264 capability surface)"'),
    ('    ap.add_argument("--device", default="cuda",\n'
     '                    help="where the frames are encoded: cuda or '
     'cpu")\n', ""),
    ("Encoder(p, device=args.device)", "Encoder(p)"),
    ("r.y.cpu()", "r.y"), ("r.u.cpu()", "r.u"), ("r.v.cpu()", "r.v"),
]


def _module_code(src: str) -> str:
    """A module's code without its docstring and import statements."""
    tree = _DropImports().visit(ast.parse(src))
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        tree.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", CLI_MODULES + ["cli.py"])
def test_cli_modules_are_copies(rel):
    """The port's CLI modules are the reference's, docstrings and import
    lines aside; cli.py also but for ``CLI_CHANGES``, each of which is
    made exactly once."""
    with open(os.path.join(REPO, "x264_tpu_torch", rel)) as f:
        port = f.read()
    with open(os.path.join(REPO, "x264_tpu", rel)) as f:
        ref = f.read()
    if rel == "cli.py":
        for new, old in CLI_CHANGES:
            assert port.count(new) == 1, new
            port = port.replace(new, old)
    assert _module_code(port) == _module_code(ref)


# the host-syntax path's copies (the FrameSyntax layer, the CAVLC writers
# and the NumPy tier of backend="reference"): each module's definitions
# are the reference's, docstrings and import lines aside, but for the
# ones a copy leaves out because nothing in the port reaches them
SYNTAX_MODULES = {
    "models/syntax.py": (),
    "bitstream/cavlc.py": ("_vlc_dict", "_CT_DICTS", "_read_vlc",
                           "read_residual_block", "_read_row_vlc"),
    "bitstream/cavlc_vec.py": (),
    "bitstream/slice_writer.py": (),
    "bitstream/slice_writer_vec.py": (),
    "models/mvpred.py": (),
    "models/intra_frame.py": (),
    "models/inter_frame.py": (),
    "ops/reference/pixel.py": (),
    "ops/reference/predict.py": (),
    "ops/reference/quant.py": (),
    "ops/reference/transform.py": (),
    "ops/reference/mc.py": (),
    "ops/reference/deblock.py": (),
}


def _definitions(src: str) -> dict:
    """A module's top-level definitions by name, as AST dumps without
    docstrings and import statements."""
    out = {}
    for node in _DropImports().visit(ast.parse(src)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            body = node.body
            if isinstance(body[0], ast.Expr) and \
                    isinstance(body[0].value, ast.Constant):
                node.body = body[1:]
            out[node.name] = ast.dump(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out[",".join(ast.unparse(t) for t in targets)] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", list(SYNTAX_MODULES))
def test_syntax_modules_are_copies(rel):
    """Every definition of the port's copy is the reference's, and every
    definition of the reference's module is in the copy but the ones it
    leaves out."""
    with open(os.path.join(REPO, "x264_tpu_torch", rel)) as f:
        port = _definitions(f.read())
    with open(os.path.join(REPO, "x264_tpu", rel)) as f:
        ref = _definitions(f.read())
    assert set(port) == set(ref) - set(SYNTAX_MODULES[rel])
    for name, code in port.items():
        assert code == ref[name], name


# single functions of the host-syntax path copied into other modules:
# (reference module, reference name, port module, port name)
SYNTAX_FUNCTIONS = [
    (r_tables, "chroma_qp", t_tables, "chroma_qp"),
    (r_yuv, "expand_border", t_yuv, "expand_border"),
    (r_cabac_host, "write_slice_cabac", t_entropy_pack,
     "write_slice_cabac_syn"),
]


@pytest.mark.parametrize("ref_mod,ref_name,port_mod,port_name",
                         SYNTAX_FUNCTIONS,
                         ids=[c[3] for c in SYNTAX_FUNCTIONS])
def test_syntax_functions_are_copies(ref_mod, ref_name, port_mod,
                                     port_name):
    """The same arguments and body, docstrings and import statements
    aside."""
    def code(fn):
        tree = _DropImports().visit(ast.parse(textwrap.dedent(
            inspect.getsource(fn))))
        node = tree.body[0]
        body = node.body
        if isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant):
            body = body[1:]
        return ast.dump(node.args) + "".join(ast.dump(b) for b in body)

    assert code(getattr(port_mod, port_name)) == \
        code(getattr(ref_mod, ref_name))


def test_zones_parse_like_reference():
    spec = "0,3,q=20/4,9,b=0.5"
    assert t_params.parse_zones(spec) == r_params.parse_zones(spec)


def _imports_of(path):
    """Top-level package names imported by a Python file, plus any
    importlib/__import__ call naming a module by a string."""
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            names.append(node.args[0].value)
    return [n.split(".")[0] for n in names]


def test_lookahead_modules_stand_alone():
    """models/lookahead.py and models/mbtree.py import neither jax nor
    x264_tpu, and import with both blocked."""
    for mod in ("lookahead", "mbtree"):
        path = os.path.join(REPO, "x264_tpu_torch", "models", f"{mod}.py")
        assert not set(_imports_of(path)) & {"x264_tpu", "jax", "jaxlib"}
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['x264_tpu'] = None; "
            "import x264_tpu_torch.models.lookahead, "
            "x264_tpu_torch.models.mbtree; print('OK')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("OK"), r.stderr[-2000:]


def test_port_never_imports_the_reference_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, fs in os.walk(os.path.join(REPO, "x264_tpu_torch")):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    bad = {f: sorted(set(m for m in _imports_of(f)
                         if m in ("x264_tpu", "jax", "jaxlib", "bench")))
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


def _clip(n, w=64, h=48):
    rng = np.random.default_rng(7)
    tex = rng.integers(0, 256, (h + 2 * n, w + 3 * n)).astype(np.uint8)
    return [(np.ascontiguousarray(tex[t:t + h, 2 * t:2 * t + w]),
             np.ascontiguousarray(tex[::2, ::2][:h // 2, :w // 2]),
             np.ascontiguousarray(tex[1::2, ::2][:h // 2, :w // 2]))
            for t in range(n)]


def test_two_pass_matches_reference(tmp_path):
    """Pass 1 writes the same stats file, pass 2 reads it back into the
    same QP plan and the same stream, in the port as in the reference."""
    frames = _clip(4)
    streams = {}
    for side, (P, E, F) in dict(
            port=(t_params, lambda p: Encoder(p, device="cpu"), Frame420),
            ref=(r_params, RefEncoder, RefFrame)).items():
        kw = dict(width=64, height=48, cabac=True, bframes=0,
                  scenecut_threshold=0, rc_method=P.RC_ABR, bitrate=400)
        stats = str(tmp_path / f"{side}.stats")
        enc = E(P.EncoderParams(stats_write=stats, **kw))
        first = b"".join(enc.encode(F(*f)) for f in frames)
        enc.close()
        enc = E(P.EncoderParams(stats_read=stats, **kw))
        second = b"".join(enc.encode(F(*f)) for f in frames)
        streams[side] = (first, open(stats).read(), second)
    assert streams["port"] == streams["ref"]


def test_host_paths_match_reference():
    """Zones, forced frame types and QPs, the access-unit log and the
    close() summary: the same in the port as in the reference."""
    frames = _clip(4)
    out = {}
    for side, (P, E, F) in dict(
            port=(t_params, lambda p: Encoder(p, device="cpu"), Frame420),
            ref=(r_params, RefEncoder, RefFrame)).items():
        enc = E(P.EncoderParams(width=64, height=48, cabac=True,
                                bframes=0, scenecut_threshold=0,
                                zones="0,1,q=30/2,3,b=0.5"))
        stream = b"".join([enc.encode(F(*frames[0])),
                           enc.encode(F(*frames[1]), qp=20),
                           enc.encode(F(*frames[2]),
                                      frame_type=P.TYPE_IDR),
                           enc.encode(F(*frames[3]))]) + enc.flush()
        out[side] = (stream, [s.frame_type for s in enc.stats],
                     [s.qp for s in enc.stats], enc.drain_au_meta(),
                     enc.close(), enc.summary_lines())
    assert out["port"] == out["ref"]
    assert out["port"][1] == ["IDR", "P", "IDR", "P"]


def test_crowded_jax_executables_are_unmapped():
    """tests/_jax_maps.py frees the reference's compiled programs: 40
    jitted programs add mappings, a clear below the threshold does
    nothing, and one past it takes the mappings back; the fixture's
    generator clears a crowded process before its test (programs that
    earlier tests left) and again after it (the test's own)."""
    import jax
    import jax.numpy as jnp
    from _jax_maps import cleared_around, free_if_crowded, maps_held

    def crowd():
        fns = [jax.jit(lambda x, k=k: x * k + 1) for k in range(40)]
        for k, f in enumerate(fns):
            f(jnp.zeros(k + 1)).block_until_ready()
        return maps_held()

    base = maps_held()
    held = crowd()
    assert held >= base + 40
    assert not free_if_crowded(limit=4 * held + 4000)
    assert free_if_crowded(limit=4)
    assert maps_held() < held - 40
    around = cleared_around(limit=4)
    held = crowd()
    next(around)                       # before the test
    assert maps_held() < held - 40
    held = crowd()                     # the test's own programs
    assert next(around, "after") == "after"
    assert maps_held() < held - 40
