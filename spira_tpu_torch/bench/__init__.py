"""Profiling scripts of the port: the counterparts of the JAX package's
``benchmarks/vpu_peak.py`` (:mod:`.vpu_peak`, kernel #9) and
``benchmarks/packet_profile.py`` (:mod:`.packet_profile`, kernel #10 and
the counting build of kernel #2).  They run on the card, print JSON lines
to stdout (or append them to a path the caller gives) and write nothing
under ``benchmarks/``."""
