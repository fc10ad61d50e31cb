"""Models of the port (the Mistral-family decoder, the BERT encoder),
the tokenizers and checkpoint reading."""
