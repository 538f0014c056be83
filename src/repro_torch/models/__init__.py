"""Dense transformer, attention and in-step sampling of the port."""
