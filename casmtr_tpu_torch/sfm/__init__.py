"""Structure from motion in the port (counterpart of casmtr_tpu/sfm/): the
batched relative-pose solver (``pose``), geometry (``geometry``), bundle
adjustment with the Schur complement and PCG (``ba``), pose-graph
optimisation (``pose_graph``), problem assembly and the trajectory error
(``reconstruct``), EPnP in RANSAC on the host (``pnp``) and the keyframe
pipeline (``pipeline``)."""
