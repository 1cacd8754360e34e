"""The animated decode across CUDA streams, on the card: an
``AnimationPlayer`` prefetching on its own stream while a caller on
another stream shares its ``AnimatedImage``, and a frame that its caller
frees while work of its own stream still reads it.  Marked ``cuda``; each
test skips without a card.  On a machine with one, from the repository's
root (``--noconftest``: ``tests/conftest.py`` configures JAX, which these
tests do not use):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_streams.py

The frames are held against the same image decoded on the CPU (the
kernels' plain twins): the sprite animation is lossless and A10 equals
its twin, so the frames are equal.
"""

import threading

import numpy as np
import pytest
import torch

from jxl_coder_tpu_torch import animation
import port_fixtures as F

pytestmark = pytest.mark.cuda

H, W = 40, 48          # the sprite animation's canvas
SH, SW = 16, 20        # its sprites


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def sprites(card):
    data = F.sprite_animation(H, W, SH, SW)
    img = animation.AnimatedImage(data, "cpu")
    return data, [img.get_frame(i) for i in range(img.frames_count)]


class _Store(animation.AnimatedStore):
    """The image's frames, each copied twice on the player's stream before
    its download: memory that stream allocates and writes while the caller
    composes on its own."""

    def get_frame(self, i: int) -> np.ndarray:
        t = self._image.frame_tensor(i)
        return t.to(torch.int16).to(torch.uint8).cpu().numpy()


def test_player_and_caller_on_their_own_streams(card, sprites):
    """A player working on its stream and a caller reading frames of the
    same image on another stream both get the CPU's frames."""
    data, expect = sprites
    img = animation.AnimatedImage(data, card)
    n = img.frames_count
    player = animation.AnimationPlayer(_Store(img), preheat=3)
    errs = []

    def caller():
        try:
            with torch.cuda.stream(torch.cuda.Stream(card)):
                for i in list(range(n))[::-1] + [0, 3, 1, n - 1, 2, 5, 4]:
                    if not np.array_equal(img.get_frame(i), expect[i]):
                        errs.append(("caller", i))
        except Exception as e:  # pragma: no cover
            errs.append(repr(e))

    t = threading.Thread(target=caller)
    t.start()
    try:
        for k in range(2 * n):
            if not np.array_equal(player.current(), expect[k % n]):
                errs.append(("player", k % n))
            player.advance()
    finally:
        t.join()
        player.close()
    assert not errs, errs


def test_a_frame_outlives_its_free_on_the_callers_stream(card, sprites):
    """A composed frame read by work still queued on the caller's stream
    keeps its memory after the caller drops it, while the image composes
    further frames on its own stream."""
    data, expect = sprites
    img = animation.AnimatedImage(data, card)
    k = 3                               # a cropped sprite, composed
    caller = torch.cuda.Stream(card)
    with torch.cuda.stream(caller):
        out = img.frame_tensor(k)
        torch.cuda._sleep(100_000_000)  # the read waits behind this
        seen = out.clone()
    del out
    for j in range(k + 1, img.frames_count):
        img.frame_tensor(j)
    caller.synchronize()
    assert np.array_equal(seen.cpu().numpy(), expect[k])
