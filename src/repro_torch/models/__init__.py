"""The LM stack of the port: config, layers, attention, the Griffin
recurrent block, the Mamba block and the composed decoder."""
