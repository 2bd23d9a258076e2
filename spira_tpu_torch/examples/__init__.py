"""The user-facing example scripts of ``examples/``, ported: one module
per script, each run as ``python -m spira_tpu_torch.examples.<name>`` with
the script's own arguments, on the card.  Each has a ``run(...)`` whose
keyword defaults are the script's constants and which takes
``device="cpu"`` to run on the host:

* :mod:`.basic_render`: the sphere demo, 640x360, spp 16, depth 4;
* :mod:`.dof_render`: the demo through a thin lens, spp 64;
* :mod:`.cornell_spectral`: the spectral Cornell box, 512x512, depth 6;
* :mod:`.mesh_bvh`: an OBJ (or the icosphere stand-in) through the packed
  BVH;
* :mod:`.adaptive_render`: variance-guided sampling by row;
* :mod:`.inverse_rendering`: Adam on the demo's albedos and emissions;
* :mod:`.distributed_render`: the sharded render under ``torchrun``.
"""
