"""Dense transformer models of the port: layers, the LM, the model API."""
