"""TTS backends (the protocol and the deterministic fake) and the waveform
stitcher."""
