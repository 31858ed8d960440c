"""The port's serving tier: the LM tier's batched `ServeEngine`."""
