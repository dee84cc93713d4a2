"""PyTorch / CUDA port of vln_ver_tpu for NVIDIA Hopper.

The JAX package ``vln_ver_tpu`` is the reference; this package imports
nothing of it.  It ports VER volume generation (the ``only_bev`` forward of
``VoxelFormer`` and the HDF5 dump, ``get_occ``) and the full forward with
its eval path (decoder, branches, occupancy head, decode, metrics,
``test``), training, the VLN agent, the VER server (``serve``) and the
(data, view) process grid behind every ``--mesh`` (``parallel``), the
temporal lineage and BEVFormer-2D, the 36-view headline measurement
(``bench``) and the JAX tools' counterparts.  The encoder's deformable
sampling runs in a hand-written CUDA kernel (``csrc/deform_attn_2d.cu``).
"""
