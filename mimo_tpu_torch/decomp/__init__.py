"""The decomposition half of the port: in-the-wild video -> template."""
