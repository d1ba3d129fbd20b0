"""Host-side utilities: WAV I/O, TextGrid I/O, French POS, text normalisation."""
