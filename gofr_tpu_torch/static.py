"""Embedded static assets (reference ``pkg/gofr/static/files.go:5-8`` embeds a
favicon via embed.FS). A minimal valid 16x16 1-bit ICO, generated in code to
keep the repo binary-free.

The port's copy of ``gofr_tpu/static.py``.
"""

import struct


def _build_favicon() -> bytes:
    # ICO header + one 16x16 monochrome BMP entry.
    width = height = 16
    # BITMAPINFOHEADER (height doubled for XOR+AND masks)
    bmp_header = struct.pack(
        "<IiiHHIIiiII", 40, width, height * 2, 1, 1, 0, 0, 0, 0, 2, 0
    )
    palette = struct.pack("<II", 0x00000000, 0x00FFFFFF)  # black, white
    # XOR mask: simple "T" glyph (TPU), 16 rows bottom-up, 4 bytes/row padding.
    rows = []
    glyph = [
        0b0000000000000000,
        0b0000000000000000,
        0b0000001111000000,
        0b0000001111000000,
        0b0000001111000000,
        0b0000001111000000,
        0b0000001111000000,
        0b0000001111000000,
        0b0000001111000000,
        0b0000001111000000,
        0b0011111111111100,
        0b0011111111111100,
        0b0011111111111100,
        0b0000000000000000,
        0b0000000000000000,
        0b0000000000000000,
    ]
    for row in reversed(glyph):
        rows.append(struct.pack(">H", row) + b"\x00\x00")
    xor_mask = b"".join(rows)
    and_mask = (b"\x00\x00\x00\x00") * height  # all visible
    image = bmp_header + palette + xor_mask + and_mask
    icondir = struct.pack("<HHH", 0, 1, 1)
    entry = struct.pack(
        "<BBBBHHII", width, height, 2, 0, 1, 1, len(image), 6 + 16
    )
    return icondir + entry + image


FAVICON = _build_favicon()
