"""Training of the port: losses, the ADA pipe, masks and the train step."""
