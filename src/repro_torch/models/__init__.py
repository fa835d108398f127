"""Model building blocks of the port."""
