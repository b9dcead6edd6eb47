"""The federation harness: CNNFederation."""
