"""TTS backends (the protocol, the Azure REST client and the deterministic
fake) and the waveform stitcher."""
