"""Runnable tools over the port (python -m mvsformerplusplus_tpu_torch.tools.<name>):
the end-to-end accuracy protocol (e2e_protocol), the DINOv2 dense matcher
(dino_match), and the trace profilers of the bench's eval forward and train
step on the card (profile_eval, profile_train)."""
