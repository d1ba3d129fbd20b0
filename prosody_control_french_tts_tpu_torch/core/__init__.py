"""Core: phase timing and the pipeline's measure-and-SSML step."""
