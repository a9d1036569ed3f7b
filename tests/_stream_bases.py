"""The frame sizes of the port's CPU tests, each with why it is used.

Every frame core of the reference (``i_frame_core``, ``i4_frame_core``,
``p_frame_core``, ``b_frame_core``, ``b_pair_core``, the deblock and the
entropy tail) is a JAX program per frame size, through its static
``mbw``/``mbh`` and its arguments' shapes, and per setting that is
static.  Tracing and compiling those programs for the reference, not
the port's own work, is most of what the port's tests cost on the CPU.
So the port's tests use few sizes, and where they can, the sizes the
reference's own tests use: a program the reference's tests compiled is
then read from the persistent compile cache, and a program one case
traced serves the next case on the same xdist worker.

An odd size pads to whole macroblocks, so 90x58 runs 96x64's programs
and still crops the stream's right and bottom edges (SPS cropping,
padded MBs, odd chroma planes).  96x64 is where the reference's own
tests compile most of their frame cores (tests/test_e2e.py,
test_parts_e2e.py, test_bframes.py, test_trellis.py, test_weightp.py),
so the port's streams run there.

``tests/test_torch_suite_budget.py`` fails when a port test brings a
size that ``SIZES`` does not name.  It reads the sizes the files give
as a width and a height (the stream and encoder cases), not the tests
that call a core of the reference on a number of MBs:
``tests/test_torch_cores.py`` holds its cores on 6x4 MBs (96x64), and
the refresh-bar and deblock cases keep MB counts of their own
(``test_torch_live.py``, ``test_torch_deblock.py``).
"""

SMALL = (64, 48)
MID = (96, 64)
LOWRES = (160, 96)
ODD = (90, 58)

SIZES = {
    MID: "the reference's main test size (tests/test_e2e.py and others), "
         "6x4 MBs: the streams, four MB rows for slices and the band "
         "mesh, the reference's 80-row band at me_range 31, the lookahead "
         "on 48x32 lowres planes",
    SMALL: "tests/test_e2e.py's small size, 4x3 MBs: the I4 cores held "
           "field by field (test_torch_intra4.py), the I/P16 streams at QP "
           "0/26/51 and the encoder's refusals (test_torch_encoder.py), "
           "the reference backend (test_torch_syntax.py)",
    LOWRES: "tests/test_lookahead.py's and test_mbtree.py's: the lowres "
            "functions on an 80x48 lowres plane (5x3 lowres MBs)",
    ODD: "the odd size: crops 6 columns and 6 rows, chroma 45x29, on "
         "96x64's programs",
    (32, 32): "tests/test_bframes.py's POC wrap: 135 frames of 2x2 MBs",
    (1920, 1080): "constructs only (threads at open, the warm predicate): "
                  "no frame is encoded",
    (800, 640): "the warm predicate at 2000 MBs: no frame is encoded",
    (784, 640): "the warm predicate at 1960 MBs: no frame is encoded",
}
