"""The port's `graft_entry.entry("cpu")` against the reference's
`__graft_entry__.entry()` (jitted, on the CPU) on the same seeded numpy
arguments: the reference's own example arguments (random images, an
empty window) and the same arguments with a rendered grid stereo pair in
place of the images, which gives the line detector segments to find.

Both entries build their frame at `build_frame_stereo`'s default line
capacity, 8 slots, and run the line detector on the left image. Tolerances: the
inlier count and the frame's valid-line count equal, Tcw within 1e-5."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.slam import frame as JF
from splslam_tpu_torch import graft_entry
from splslam_tpu_torch.io.synthetic import make_stereo_sequence
from splslam_tpu_torch.slam import frame as TF

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import __graft_entry__ as JG  # noqa: E402

TCW_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_args(images):
    _, spec, _, local_m = JG._setup()
    args = list(JG._example_args(spec, local_m))
    if images == "grid":
        _, _, frames, _ = make_stereo_sequence(n_frames=1, width=128, height=96,
                                               texture="grid", seed=1)
        args[0], args[1] = (np.asarray(x, np.float32) for x in frames[0])
    return args


def _port_args(jargs):
    """The reference's arguments in the port's layout: no `last_xy`, the
    +-1 bit planes packed into [N,8] int32 words, window words as int32."""
    imgL, imgR, _, last_oct, last_ang, last_bits, *rest = jargs
    packed = np.packbits(last_bits > 0, axis=-1, bitorder="little")
    last_desc = packed.view(np.uint32).view(np.int32)
    rest[5] = rest[5].view(np.int32)                 # window descriptors
    return [imgL, imgR, last_oct, last_ang, last_desc, *rest]


@pytest.mark.parametrize("images", ["reference", "grid"])
def test_entry_matches_the_reference_entry(images):
    jargs = _jax_args(images)
    jfn, jex = JG.entry()
    assert [a.shape for a in jargs] == [a.shape for a in jex]
    Tj, nj = jax.jit(jfn)(*map(jnp.asarray, jargs))

    fn, ex = graft_entry.entry("cpu")
    targs = _port_args(jargs)
    if images == "reference":
        # the port's own example arguments are the reference's, converted
        for a, b in zip(ex, targs):
            np.testing.assert_array_equal(a.numpy(), b)
    Tt, nt = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in targs))
    assert int(nt) == int(nj)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=TCW_ATOL)

    # the frame both steps build: an 8-slot line table, the same lines
    jcam, jspec, _, _ = JG._setup()
    tcam, tspec, scales, _ = graft_entry._setup("cpu")
    jf = JF.build_frame_stereo(jnp.asarray(jargs[0]), jnp.asarray(jargs[1]), jcam, jspec)
    tf = TF.build_frame_stereo(torch.from_numpy(jargs[0]), torch.from_numpy(jargs[1]),
                               tcam, tspec, scales)
    assert tf.lines.capacity == jf.lines.capacity == 8
    n_lines = int(np.asarray(jf.lines.valid).sum())
    assert int(tf.lines.valid.sum()) == n_lines
    if images == "grid":
        assert n_lines > 0
