"""Offline tools (the port's copy of the reference's ``tools`` package):

- ``python -m opticalflowcontainer_tpu_torch.tools.run_pair`` -- flow of two
  PNG stills, written as ``.flo`` and an HSV PNG;
- ``python -m opticalflowcontainer_tpu_torch.tools.fish_speed`` -- the mean
  displacement and metric speed of a region of interest from a still pair;
- ``python -m opticalflowcontainer_tpu_torch.tools.zoo_latency`` -- device
  ms per frame of each learned family at its reference operating point;
- ``python -m opticalflowcontainer_tpu_torch.tools.monitor`` -- per-process
  CPU and RSS sampling to CSV, and the summary of the device-memory logs;
- ``python -m opticalflowcontainer_tpu_torch.tools.train_flow`` -- train a
  family of the zoo on synthetic affine motion and export its flat npz;
- ``python -m opticalflowcontainer_tpu_torch.tools.pwc_distill_extractor``
  -- distill the LFN3 trunk into PWC-Net's extractor (stage A of its
  bootstrap);
- ``python -m opticalflowcontainer_tpu_torch.tools.record`` -- frames of a
  Motion-JPEG or uncompressed AVI to an uncompressed AVI and/or numbered
  PNGs;
- ``python -m opticalflowcontainer_tpu_torch.tools.comparison`` -- two PNG
  or JPEG images as a 2-frame looping GIF.
"""
