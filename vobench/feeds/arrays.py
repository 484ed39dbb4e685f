"""Feed `arrays`: the period's uint8 frames held in host memory as numpy
arrays, handed to `process()` as they are (the engine uploads them:
`BaseVO._upload` through its pinned staging buffers). Frame i is image
`i mod P`."""

from __future__ import annotations


class Feed:
    def __init__(self, ctx):
        self.frames = ctx.frames_host
        self.stereo = ctx.stereo
        self.i = 0
        self.waits = None

    def next(self):
        """The next frame's arguments to `process()`."""
        img = self.frames[self.i % len(self.frames)]
        self.i += 1
        return (img[0], img[1]) if self.stereo else (img,)

    def close(self):
        pass
