"""Profiling scripts of the port: the counterparts of the JAX package's
``benchmarks/vpu_peak.py`` (:mod:`.vpu_peak`, kernel #9) and
``benchmarks/packet_profile.py`` (:mod:`.packet_profile`, kernel #10 and
the counting build of kernel #2); the adjoint kernel (#6) and the
differentiable step's times (:mod:`.grad_step`), and the mesh path
tracers' (#2, #5, with #2b and #3; :mod:`.mesh_frame`), each for this
checkout or another.  They run on the card, print JSON lines to stdout (or append
them to a path the caller gives) and write nothing under
``benchmarks/``.  :mod:`.spans` reduces a profile of the program's own
spans: each device record and each idle gap put down to a span."""
