"""Model parts of the port: attention, RNN cells, decoder, the dual captioner."""
