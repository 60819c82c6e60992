"""Host-side IO of the port: tokenizer, video frames, latent trajectories."""
