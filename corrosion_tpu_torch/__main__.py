"""`python -m corrosion_tpu_torch` → the corrosion CLI on the port."""

from corrosion_tpu_torch.cli import main

if __name__ == "__main__":
    main()
