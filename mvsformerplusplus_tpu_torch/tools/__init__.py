"""Runnable tools over the port (python -m mvsformerplusplus_tpu_torch.tools.<name>):
the end-to-end accuracy protocol (e2e_protocol) and the DINOv2 dense matcher
(dino_match)."""
