"""``none``: the radiance as it is (``to_uint8`` clips it).  A frozen copy,
at commit 86df806, of ``spira_tpu_torch/io/image.py:TONEMAPS['none']``."""


def apply(hdr):
    return hdr
