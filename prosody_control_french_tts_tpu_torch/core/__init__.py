"""Core: configuration, phase timing, the voice pipeline, the multi-voice
runner and the synchronized-SSML flow."""
